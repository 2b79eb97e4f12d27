"""The PyTorch port (the eval and train paths, the data pipeline, the eval
harness, both CLIs, the msgpack reader, the dependency block, the bench)
and chip_smoke.py import neither JAX nor the JAX package: every module
imports with jax, flax, optax and msgpack blocked."""

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
            "models.dependency"}
missing = {"unav_yolyolva_tpu_torch." + n for n in required} - set(names)
assert not missing, missing
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
