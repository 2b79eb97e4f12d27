"""Where one train step's grads on the card part from the CPU's, and why.

    python -m unav_yolyolva_tpu_torch.tools.grad_gaps [--seeds 2 3 4] [--batch b.pt ...]

For each train batch (synthetic from --seeds at B=2, and files written with
torch.save of a train batch dict), at the protocol of
configs/avel_unav100.yaml with random weights from --seed and droppath off,
it prints:
  * the tensors whose grads on the card part most from the CPU plain
    path's, norm-wise, each with its norm over the largest grad's norm;
  * how far the card's grads of those tensors move when the features move
    by 1e-7 of themselves (a smooth function moves them by about as much
    as fp32 rounding does);
  * from the CPU forward, each CSP gate's smallest top-2 margin of its max
    over guide tokens, relative to the position's largest |score|, and
    the count of valid positions under 1e-5, in forward order (the five
    top-down layers, then the five bottom-up): where rounding can cross
    the margin, the max's grad goes to another token.
`chip_smoke.py` takes its one-step grads from `step_grads` here.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GATE_SCORES = "rthc,rnhc->rhtn"      # the einsum of fused_csp.csp_reference's gate


def step_grads(model, cfg, batch, dev):
    """One train step's loss and grads (no update) of `model` on `dev`."""
    import torch

    from ..geometry.points import concat_points, generate_points
    from ..models.meta_arch import compute_losses
    from ..train.step import BATCH_KEYS, build_targets, loss_kwargs

    m = cfg["model"]
    model = model.to(dev).train()
    b = {k: batch[k].to(dev) for k in BATCH_KEYS}
    pts = torch.from_numpy(concat_points(generate_points(
        m["max_seq_len"], m["regression_range"], m["scale_factor"]))).to(dev)
    ms, mse, ml, gcls, greg = build_targets(b, pts, m["max_seq_len"], m["num_classes"],
                                            m["class_aware"])
    out = model({"visual": b["visual"], "audio": b["audio"], "mask": b["mask"],
                 "m_scores": ms, "m_start_end": mse, "m_labels": ml})
    loss = compute_losses(out, gcls, greg, torch.tensor(250.0, device=dev),
                          **loss_kwargs(cfg))[0]["final_loss"]
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def ulp_bump(x, mask, gen, sign):
    """x (R, T, C), bf16 or fp32, with one valid value of each row moved by
    one bf16 ulp of its bf16 rounding (away from zero with sign +1, towards
    it with -1): the smallest change a bf16 program sees. A row without a
    valid position is left as it is."""
    import torch

    x = x.clone()
    lengths = mask.sum(1).cpu()
    for i in range(x.shape[0]):
        if lengths[i] == 0:
            continue
        valid = mask[i].nonzero().flatten().cpu()
        j = int(valid[int(torch.randint(len(valid), (1,), generator=gen))])
        k = int(torch.randint(x.shape[-1], (1,), generator=gen))
        b = x[i, j, k:k + 1].bfloat16()
        step = sign if float(b) != 0 else 1          # 0 - 1 in bits is a NaN
        moved = (b.view(torch.int16) + step).view(torch.bfloat16)
        x[i, j, k] += (moved.float() - b.float()).to(x.dtype)[0]
    return x


@contextlib.contextmanager
def gate_margins(rows):
    """Inside, each CPU CSP forward appends (T, smallest relative top-2
    margin, positions under 1e-5, valid positions) of its gate to rows."""
    import torch

    from ..ops import fused_csp

    plain, einsum = fused_csp.csp_reference, torch.einsum

    def traced(x, guide, mask, *args, **kw):
        def scores(eq, *ops):
            out = einsum(eq, *ops)
            if eq == GATE_SCORES:
                s = out.detach()
                top = s.topk(2, dim=-1).values
                rel = (top[..., 0] - top[..., 1]) / s.abs().amax(-1).clamp_min(1e-30)
                rel = rel[mask[:, None, :].expand_as(rel)]
                rows.append((x.shape[1], float(rel.min()), int((rel < 1e-5).sum()),
                             rel.numel()))
            return out

        torch.einsum = scores
        try:
            return plain(x, guide, mask, *args, **kw)
        finally:
            torch.einsum = einsum

    fused_csp.csp_reference = traced
    try:
        yield
    finally:
        fused_csp.csp_reference = plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[2, 3, 4])
    ap.add_argument("--batch", nargs="*", default=[])
    ap.add_argument("--top", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from ..core import load_config, resolve_device
    from ..data.synthetic import synthetic_train_batch
    from ..models import build_model

    dev, cpu = resolve_device("cuda"), torch.device("cpu")
    cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100.yaml"))
    m = cfg["model"]
    init = build_model(cfg, device="cpu", seed=args.seed)
    for mod in init.modules():
        if hasattr(mod, "drop_prob"):
            mod.drop_prob = 0.0
    batches = {path: torch.load(path) for path in args.batch}
    for s in args.seeds:
        batches[f"seed {s}"] = synthetic_train_batch(
            torch.Generator().manual_seed(s), 2, m["max_seq_len"], m["raw_input_dim_V"],
            m["raw_input_dim_A"], m["num_classes"], cfg["dataset"]["max_num_events"])
    for name, batch in batches.items():
        gpu_loss, gg = step_grads(copy.deepcopy(init), cfg, batch, dev)
        rows = []
        with gate_margins(rows):
            cpu_loss, cg = step_grads(copy.deepcopy(init), cfg, batch, cpu)
        noise = torch.Generator().manual_seed(args.seed + 11)
        moved = dict(batch, **{k: batch[k] * (1 + 1e-7 * torch.randn(batch[k].shape,
                                                                     generator=noise))
                               for k in ("visual", "audio")})
        _, pg = step_grads(copy.deepcopy(init), cfg, moved, dev)
        big = max(float(g.norm()) for g in cg.values() if g is not None)
        gaps = sorted(((float((gg[n].cpu() - g).norm() / g.norm()), n)
                       for n, g in cg.items()
                       if g is not None and float(g.norm()) > 1e-6 * big),
                      reverse=True)[: args.top]
        print(f"{name}: loss card {gpu_loss:.6f}, cpu {cpu_loss:.6f}")
        for gap, n in gaps:
            ref = float(cg[n].norm())
            print(f"  {n}: card vs cpu {gap:.3e}, norm / largest {ref / big:.2e}, moved by "
                  f"a 1e-7 input move {float((pg[n] - gg[n]).norm()) / ref:.3e}")
        for i, (t, low, n5, n) in enumerate(rows):
            print(f"  CSP gate {i} (T={t}): smallest top-2 margin {low:.3e}, "
                  f"{n5} of {n} positions under 1e-5")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
