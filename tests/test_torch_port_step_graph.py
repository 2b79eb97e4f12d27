"""The backbone's positional table and the train step's CUDA-graph
bookkeeping, on the CPU (no JAX): the table is built once per (length,
device) with the bits of the formula every forward used to evaluate, and
is no module state; on the CPU the train step runs every step eagerly,
and each step's returned losses are its own. The graph path itself runs
on the card (`test_torch_port_gpu.py`)."""

import pytest
import torch

from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

NCLS, NE, T = 5, 8, 64


def _old_table(max_len: int, n_embd: int, t: int) -> torch.Tensor:
    """The table as ConvTransformerBackbone.forward built it on every call."""
    from unav_yolyolva_tpu_torch.ops.masked import interpolate_pe_linear, sinusoid_encoding

    pe = torch.from_numpy(sinusoid_encoding(max_len, n_embd)) / (n_embd ** 0.5)
    return interpolate_pe_linear(pe, t) if t >= max_len else pe[:t]


@pytest.mark.parametrize("t", [224, 300, 100])
def test_pe_table_keeps_the_bits_and_is_built_once(t):
    from unav_yolyolva_tpu_torch.models.backbone import ConvTransformerBackbone

    with torch.device("meta"):
        bb = ConvTransformerBackbone(n_embd=512, max_len=224, use_abs_pe=True)
    cpu = torch.device("cpu")
    pe = bb.pe_table(t, cpu)
    assert pe.shape == (t, 512) and pe.dtype == torch.float32 and pe.device == cpu
    assert torch.equal(pe, _old_table(224, 512, t))
    assert bb.pe_table(t, cpu) is pe
    assert not any("_pe" in k for k in bb.state_dict())


def test_backbone_forwards_build_the_table_once(monkeypatch):
    import unav_yolyolva_tpu_torch.models.backbone as backbone

    calls = []

    def counted(*a):
        calls.append(a)
        return encode(*a)

    encode = backbone.sinusoid_encoding
    monkeypatch.setattr(backbone, "sinusoid_encoding", counted)
    torch.manual_seed(0)
    bb = backbone.ConvTransformerBackbone(n_in_V=8, n_in_A=8, n_embd=16, n_head=4,
                                          max_len=T, arch=(2, 2, 2), use_abs_pe=True).eval()
    with torch.no_grad():
        for p in bb.parameters():
            p.uniform_(-0.3, 0.3)
    x = torch.randn(2, T, 8)
    mask = torch.arange(T)[None, :] < torch.tensor([[T], [40]])
    with torch.no_grad():
        first = bb(x, x, mask)
    with torch.inference_mode():
        again = bb(x, x, mask)
    assert len(calls) == 1
    for a, b in zip(first[0] + first[1], again[0] + again[1]):
        assert torch.equal(a, b)
    assert not any("_pe" in k for k in bb.state_dict())


@pytest.fixture(scope="module")
def cpu_steps():
    """Two train steps of a tiny model on the CPU, droppath on: the step,
    its returned losses, and each step's losses read right after it."""
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    cfg = load_config_dict({
        "dataset": {"num_classes": NCLS, "max_seq_len": T, "max_num_events": NE},
        "model": {"raw_input_dim_V": 32, "raw_input_dim_A": 16, "input_dim_V": 16,
                  "input_dim_A": 16, "embd_dim": 16, "head_dim": 16, "use_abs_pe": True},
        "opt": {"learning_rate": 1e-3, "epochs": 2, "warmup_epochs": 1},
        "train_cfg": {"droppath": 0.1},
    })
    model = build_model(cfg, device="cpu", seed=0)
    opt, _ = make_optimizer(model, cfg["opt"], 2)
    state = create_train_state(model, opt, 100.0)
    step = make_train_step(model, opt, cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    outs, read = [], []
    for _ in range(2):
        outs.append(step(state, synthetic_train_batch(gen, 2, T, 32, 16, NCLS, NE), 7))
        read.append({k: v.clone() for k, v in outs[-1].items()})
    return step, outs, read


def test_cpu_train_step_runs_eagerly(cpu_steps):
    step, outs, _ = cpu_steps
    assert (step.captures, step.replays, step.eager_steps) == (0, 0, len(outs))


def test_returned_losses_outlive_the_next_step(cpu_steps):
    _, outs, read = cpu_steps
    assert outs[0].keys() == read[0].keys()
    for out, seen in zip(outs, read):
        for k in seen:
            assert torch.equal(out[k], seen[k]), k
    assert not torch.equal(outs[0]["final_loss"], outs[1]["final_loss"])
