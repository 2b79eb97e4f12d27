"""The one traffic generator: batches of pre-extracted features made from
the seed and a mix's parameters (portbench/traffic/<mix>.json), on the
device in bulk and then copied into pinned host memory, from where the
program's step copies each batch as its loops do.

Eval batches: valid lengths in [min_len, T], the first video of each batch
full (`full_first`), the pool's other rows spaced evenly over [min_len, T]
and shuffled over the pool by the seed, so that every seed serves the same
set of lengths (the same work) in another order; where `pad_last` is set,
the last row zero-padded (as the eval collate pads an epoch's final
partial batch; such a row is no video and is not counted as one); features
N(0, 1) zeroed past each length, fps / stride / frames per video and the
duration that matches the length.
Train batches: lengths drawn alike (no padded row), and `events_min` to
`events_max` events a video inside its valid frames (feature-grid units,
width >= 1), padded to max_num_events with gt_valid False.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def pool_lengths(gen, mix: Dict, t: int, dev) -> torch.Tensor:
    """(pool, batch) valid lengths of the pool's rows (see the module's
    docstring)."""
    p, b = mix["pool"], mix["batch"]
    full = 1 if mix.get("full_first", True) else 0
    n = p * (b - full)
    rest = torch.linspace(mix["min_len"], t, n, device=dev).round().long()
    rest = rest[torch.randperm(n, generator=gen, device=dev)].view(p, b - full)
    if full:
        rest = torch.cat([torch.full((p, 1), t, dtype=rest.dtype, device=dev), rest], 1)
    return rest


def eval_batch(gen, mix: Dict, model_cfg: Dict, lengths: torch.Tensor, dev
               ) -> Dict[str, torch.Tensor]:
    b, t = mix["batch"], model_cfg["max_seq_len"]
    lengths = lengths.clone()
    if mix.get("pad_last", False):
        lengths[-1] = 0
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    m = mask[..., None].float()
    stride, fps = float(mix["feat_stride"]), float(mix["fps"])
    return {
        "visual": torch.randn(b, t, model_cfg["raw_input_dim_V"], generator=gen, device=dev) * m,
        "audio": torch.randn(b, t, model_cfg["raw_input_dim_A"], generator=gen, device=dev) * m,
        "mask": mask,
        "fps": torch.full((b,), fps, device=dev),
        "duration": lengths.float() * stride / fps,
        "feat_stride": torch.full((b,), stride, device=dev),
        "feat_num_frames": torch.full((b,), float(mix["num_frames"]), device=dev),
    }


def train_batch(gen, mix: Dict, model_cfg: Dict, max_events: int, lengths: torch.Tensor, dev
                ) -> Dict:
    b, t = mix["batch"], model_cfg["max_seq_len"]
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    m = mask[..., None].float()
    n_ev = torch.randint(mix["events_min"], mix["events_max"] + 1, (b,), generator=gen,
                         device=dev)
    gt_valid = torch.arange(max_events, device=dev)[None, :] < n_ev[:, None]
    span = lengths[:, None].float()
    start = torch.rand(b, max_events, generator=gen, device=dev) * (span - 1.0)
    width = 1.0 + torch.rand(b, max_events, generator=gen, device=dev) * (span / 2.0)
    segs = torch.stack([start, torch.minimum(start + width, span)], dim=-1)
    return {
        "visual": torch.randn(b, t, model_cfg["raw_input_dim_V"], generator=gen, device=dev) * m,
        "audio": torch.randn(b, t, model_cfg["raw_input_dim_A"], generator=gen, device=dev) * m,
        "mask": mask,
        "gt_segments": segs * gt_valid[..., None],
        "gt_labels": torch.randint(0, model_cfg["num_classes"], (b, max_events), generator=gen,
                                   device=dev) * gt_valid,
        "gt_valid": gt_valid,
    }


def pinned(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A host copy of a device batch in pinned memory (a CPU batch as it is)."""
    out = {}
    for k, v in batch.items():
        if v.device.type == "cpu":
            out[k] = v
        else:
            out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            out[k].copy_(v)
    return out


def pool(seed: int, mix: Dict, cfg: Dict, dev) -> List[Dict[str, torch.Tensor]]:
    """`mix["pool"]` distinct host batches of the mix's kind, made from `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = cfg["model"]
    lengths = pool_lengths(gen, mix, m["max_seq_len"], dev)
    out = []
    for i in range(mix["pool"]):
        if mix["kind"] == "eval":
            b = eval_batch(gen, mix, m, lengths[i], dev)
        else:
            b = train_batch(gen, mix, m, cfg["dataset"]["max_num_events"], lengths[i], dev)
        out.append(pinned(b))
    return out
