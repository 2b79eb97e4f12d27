"""The PyTorch port (the eval and train paths, the data pipeline, the eval
harness, both CLIs, the msgpack reader, the dependency block, the bench,
the bf16 compute policy's kernels and their plain versions, the
data-parallel modules, the host Soft-NMS, the FLOP count and the
accuracy-cost tool) and
chip_smoke.py import neither JAX nor the JAX package: every module imports
with jax, flax, optax and msgpack blocked."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "unav_yolyolva_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Block())
import unav_yolyolva_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import unav_yolyolva_tpu_torch.train, unav_yolyolva_tpu_torch.geometry.assign
import unav_yolyolva_tpu_torch.ops.losses, unav_yolyolva_tpu_torch.utils.seed
import chip_smoke
required = {"train.step", "train.optim", "train.checkpoint", "train.loop", "core.registry",
            "builders", "data.annotations", "data.dataset", "data.pipeline", "data.synthetic",
            "geometry.points", "eval.metrics", "eval.postprocessing", "eval.cli",
            "utils.convert", "utils.profiling", "tools.bench", "train.cli", "utils.msgpack",
            "models.dependency", "ops.gemm_tc", "ops.fused_mhca", "ops.fused_csp",
            "ops.fused_tblock", "models.meta_arch", "parallel", "parallel.mesh",
            "parallel.sync", "parallel.collectives", "ops.nms_host", "tools.flops",
            "tools.accuracy_cost"}
missing = {"unav_yolyolva_tpu_torch." + n for n in required} - set(names)
assert not missing, missing
# the bf16 policy: its kernels' wrappers, plain versions and sources
from unav_yolyolva_tpu_torch.ops import cuda_build
from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_product_reference, bf16_products
from unav_yolyolva_tpu_torch.core.config import COMPUTE_DTYPES
for lib in ("mhca_bf16", "csp_bf16", "tblock_bf16", "gemm_bf16"):
    assert lib in cuda_build.KERNEL_SOURCES and (cuda_build.CSRC / (lib + ".cu")).exists(), lib
assert set(COMPUTE_DTYPES) == {"float32", "bfloat16"}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in BLOCKED)
print(len(names), bad)
assert len(names) >= 30 and not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
