#!/usr/bin/env python3
"""Drives the PyTorch port's eval (serving) and train paths on one NVIDIA GPU,
from memory and from feature files on disk, with and without the
dependency block, and its serving and train paths at the bf16 compute
policy.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. the card: name, count, nvidia-smi name and power limit;
  2. builds the fifteen hand-written CUDA kernel libraries (the eight
     kernels, the three bf16 forward and three bf16 backward kernels, and
     the tensor-core products alone, 3xTF32 and bf16) from
     unav_yolyolva_tpu_torch/csrc (one nvcc each, all at once);
  3. holds each forward kernel against its plain PyTorch version on the
     card at the shapes of the eval protocol (configs/avel_unav100_eval.yaml):
     MHCA at (64, 224, 512) and (128, 224, 256), CSP layers at T=224 and T=7
     with 4 and 8 heads at 2B=128, merged Soft-NMS at (64, 10100) x 100
     (uniform and skewed classes) and at (64, 2000) (the nms_max_candidates
     rows), the whole TransformerBlock at (64, 224, 512) and (8, 224, 512)
     with a zero-length row (beside the default path's time for the block),
     single-class Soft-NMS at (6400, 1024) x 100 (the per-class buffers of a
     batch) with the hard, linear and Gaussian weights and at (64, 10100) x
     100, each NMS case with a `stages nms@...` line (time, the longest
     row's steps and ns a step, the instantiation's registers and spills
     from ptxas, resident blocks per SM); then the tensor-core product
     alone in its three layouts at the CSP final conv's shapes: the
     forward (M=28672, N=512, K=1536), the backward's input grad (A.B,
     M=3584, N=1536, K=512) and weight grad (A^T.B, M=512, N=1536, K=3584,
     split K) at the train protocol's T=224, 2B=16: each one's error
     against fp64 within 2x that of fp32
     torch.matmul (TF32 off), the same bits on repeat, its time beside
     torch.matmul's; the product with the TransformerBlock MLP's epilogue
     alone at the stem's fc1 (GELU, its input kept, bit-equal to the product
     without the epilogue) and the train protocol's du (A.B times GELU'),
     held the same way against fp32 torch.matmul with the same epilogue;
  4. serves: the flagship model (width 512, 100 classes, T=224, fp32,
     weights from --seed) answers three batches of 64 synthetic videos
     through make_eval_step; every kernel's launch count must rise, the
     detections must be finite, sorted and inside [0, duration], and the
     first two videos must give the same detections through the CPU path;
     then the same batches with the whole-block stem (FUSED_TBLOCK
     "always": 12 TBlock and 3 MHCA launches), whose detections must agree
     with the default path's;
 4b. serves from files: make_synthetic_dataset writes 256 validation videos
     at the flagship width (48-224 frames, 100 classes, ~300 MB of .npy)
     and the model's weights go into a reference-format .pth.tar; the eval
     CLI (eval/cli.py:main) serves them on the card, four batches of 64
     through the pinned Batcher and the eval step's copy stream: the mAP
     must be finite in [0, 1], the MHCA, CSP and merged NMS kernels must
     launch, and the detections (--saveonly) must be bit-identical to
     make_eval_step fed the same batches as pageable numpy arrays; then
     the pipeline's videos/s (over the epoch, and after the first batch
     arrived) beside the in-memory step's (in turns), one
     batch's copy pinned beside pageable (CUDA events), and the share of
     the copies spent under a kernel (torch.profiler);
  5. times each kernel and its plain version with CUDA events, and the eval
     step as videos/s, the default and the whole-block stem in turns;
  6. holds the two backward kernels against their plain versions
     (torch.autograd.grad of the plain forwards) at the shapes of the train
     protocol (configs/avel_unav100.yaml, B=8): MHCA backward at
     (8, 224, 512) with an all-masked row and (16, 224, 512 / 2), CSP
     backward at T=224 and T=7 with 2B=16, the TBlock backward at
     (8, 224, 512) with an all-masked row (exact zeros); input grads within
     rtol 1e-3 / atol 1e-4, weight and multiplier grads norm-wise within
     1e-4 (sums over thousands of rows in another order); each kernel run
     twice must give the same bits; times them with CUDA events beside the
     bound, and the block's forward + backward on both stem paths;
  7. trains: the flagship model of configs/avel_unav100.yaml (B=8, T=224,
     fp32, AdamW + clip + warmup/cosine per iteration, droppath 0.1, EMA,
     weights from --seed) takes 4 steps of make_train_step on synthetic
     batches with a 2-iteration epoch: step 1 (lr = schedule(0) = 0) leaves
     every parameter bit-identical, step 2 moves them, every loss is
     finite, every parameter enters the update with a finite grad, and the
     MHCA / CSP backward kernels run as often as their forwards (>= 5 and
     10 per step that runs the wrappers: step 1 eager, step 2 captured as
     a CUDA graph; steps 3-4 replay it and launch through no wrapper);
     then times the step as clips/s and reports peak memory;
  8. one train step's gradients at B=2, full width, droppath off, through
     the CUDA kernels against the CPU plain path: norm-wise <= 1e-3 per
     parameter tensor; every parameter the JAX package trains gets a
     finite grad (the Alignment's argmax-only class heads get none: their
     grad is 0 there too);
  9. the whole-block stem in training: 4 steps at B=8 (8 TBlock forward and
     backward launches in the eager and the captured step, step 1
     bit-identical, finite losses), timed, and
     one step's grads at B=2 against the CPU plain path (norm-wise <= 1e-3);
 10. serves one batch of 64 with nms_method "hard" and one with
     multiclass_nms False (segment voting): the single-class Soft-NMS
     kernel runs, and the first two videos agree with the CPU path;
 11. serves one batch of 64 with tpu.nms_max_candidates 2000 (the merged
     Soft-NMS on the top 2000 candidates of each video): the first two
     videos agree with the CPU path;
 13. trains from files: make_synthetic_dataset writes 64 train clips and 64
     validation videos at the flagship width (48-224 frames, 100 classes);
     the train CLI (train/cli.py:main) runs configs/avel_unav100.yaml with
     its paths, epochs (2 + 1 of warmup) and eval_freq (1) overridden, -c 1:
     3 epochs of 8 steps at B=8 through the pinned Batcher and the train
     step's copy stream, the EMA validated with its losses every epoch, the
     final pass on model_best's raw weights. Every loss finite, the
     validation losses non-empty, each mAP in [0, 1], model_best, epoch_001
     and epoch_002 written, the MHCA / CSP forward and backward and the
     merged NMS kernels launched as often as the path needs; then
     `--resume epoch_001` trains epoch 2 again, and its epoch_002 weights
     must equal the straight run's (bit for bit, or within 1e-5 norm-wise
     a tensor where an op is not deterministic); one step's grads taken
     twice, with cuDNN's default and its deterministic algorithms (the
     CLI's), name the op that is not; then, as information, clips/s from
     files (over the epoch and after its first batch) beside the in-memory
     step's (also with cuDNN's default algorithms), one train batch's copy
     pinned beside pageable, the copies' share under a kernel;
 14. the dependency block (use_dependency: True): the MHCA kernel (one head
     of width 128) against its plain version at the temporal branch's
     (B*100, 224, 128) and the co-occurrence branch's (B*224, 100, 128),
     forward at B=8 and B=64 and backward at B=8, with the padded frames'
     fully masked rows exactly 0 and the same bits on repeat; the
     whole-block TBlock kernel at hidden = C = 128 the same way; one batch
     of 64 served (17 MHCA launches; the first two videos agree with the
     CPU path), and with the whole-block stem (16 TBlock launches); two
     train steps at B=8 (step 1 bit-identical, finite losses, every kernel
     forward and backward); the block's ms in a batch and in a step, the
     expand and squeeze convs' share, the peak memory; the block's two k=3
     convs on their 3xTF32 wgmma kernel (ops/conv3_tc.py) alone at level 0
     (T=224) and level 5 (T=7) of a batch of 64, each against fp64 (within
     2x cuDNN's fp32 error, the same bits on repeat), timed beside its
     3xTF32 and FFMA bounds, its plain version, cuDNN's fp32 conv1d
     (`library_ms`) and `tf32x3_linear(taps=3)` (`check/time conv3@...`
     lines), and all six levels as the block runs them (`time conv3
     block ...`), 7 launches in a served batch;
 15. the bf16 compute policy on the serving path: the bf16 MHCA (64, 224,
     512) and (128, 224, 256), CSP layer (T=224 with 4 and 8 heads, T=7)
     and whole-block TBlock (64, 224, 512) kernels against their plain
     versions (norm-wise <= 8e-3, each one's error against the fp32 plain
     version within 1.25x of the other's, the same bits on repeat), timed
     beside the fp32 kernel on the same inputs (their breakdowns by kernel
     come last, in 12); the attention alone at the CSP's and the
     stem's shapes, held the same way, timed beside PyTorch's
     scaled_dot_product_attention with its resident blocks a SM (`check/time
     attn_bf16@...`); the bf16 product alone at the CSP final conv's shape
     (its fp32 sums against fp64 within 2x fp32 torch.matmul's error, its
     bf16 output's error beside cuBLAS's bf16 torch.matmul, both times) and
     at each of the forward's product shapes beside the backward's strided
     product and cuBLAS (`time product_bf16@...`); the whole-block TBlock's
     fc1 and fc2 alone on their wgmma product, held as the product is and
     timed with their epilogues beside the fp32 sums alone, the mma.sync
     product and cuBLAS (`check/time product_bf16@fc1|fc2 ...`); three
     batches of 64 served at bf16
     with the default stem (15 bf16 MHCA, 30 bf16 CSP launches, no fp32
     MHCA / CSP / TBlock launch) and the whole-block stem (12 bf16 TBlock
     launches), the first two videos' heads against the CPU's bf16 path
     (at most 1/4 of the bf16-vs-fp32 gap or 2x the model's own move under
     one input value moved by one bf16 ulp, and at most 2e-2) and their
     detections likewise; the eval CLI on configs/avel_unav100_bf16.yaml
     over 64 synthetic videos, bit-identical to the in-memory step; the
     bench's eval at fp32 and bf16 in turns (videos/s, busy share, peak
     memory);
 16. the bf16 train step (configs/avel_unav100_bf16.yaml, B=8, T=224): the
     three bf16 backward kernels against their plain versions, small (3 x
     16 x 64, the CSP at T=16 and T=7) and at the protocol (MHCA (8, 224,
     512) and (16, 224, 256); CSP at T=224 with 4 and 8 heads and T=7, 2B=16;
     TBlock (8, 224, 512)): every grad within 1/4 of the plain version's
     bf16-vs-fp32 gap, or, where the two programs' fp32 sums round a few
     bf16 values apart and the flips spread, within 2x the kernel's own move
     under one input value of each row moved by one bf16 ulp
     (check_bf16_grads; at the protocol beside the plain version's own
     distance from the CPU's), the same bits on repeat; the small CSP and
     TBlock cases with the row picker at 1, each weight grad moving as the
     CPU plain version's (check_row_blocks); at the protocol timed beside
     the fp32 backward kernel on the same inputs, profiled kernel by kernel
     in a process of its own (a warm-up profile first; an empty profile is
     said so and fails the phase; `launches csp_bwd_bf16@...`, `launches
     mhca_bwd_bf16@...`, `launches tblock_bwd_bf16@...`): the CSP backward
     at T=224 and T=7 within 70 launches, the attention at most 3 a MHCA
     (the recompute's forward and the fused backward's two), with the host work
     of a T=7 CSP backward and of a TBlock backward, whose products encode
     their tensor maps on the host each call (`host ...`);
     the backward's bf16 product alone (A.B, and A^T.B in row blocks) at the
     CSP final conv, beside cuBLAS; three train steps with each stem, each
     bf16 backward kernel launched as often as its forward and no fp32 MHCA
     / CSP / TBlock kernel; one step's grads at B=2 against the CPU's bf16
     plain path (within 1/4 of the gap or 2x the card's one-ulp move, and
     about a gap from the CPU's fp32 grads); the train CLI
     on the bf16 config from files (3 epochs of 4 steps, validation) and a
     resume whose last epoch equals the straight run's bit for bit; the
     bench's train half at fp32 and bf16 in turns (clips/s, busy share,
     peak memory);
 17. data parallel, in a process of its own started by torchrun at one
     rank (NCCL on the card; `--dp-only`): make_train_step with the group,
     3 steps at B=8, T=224 in fp32 and bf16, bit-identical (losses,
     parameters, EMA, normalizer) to the step without a group from the same
     seed; make_eval_step with the group at B=64, fp32 and bf16, its
     gathered detections bit-identical; the train CLI under the launch on
     phase 13's files and config, its epoch_002 bit-identical to phase 13's
     straight run and its mAPs equal, then the eval CLI under the launch on
     that checkpoint; the steps' rates with and without the group in turns
     and the gradient all-reduce at the flagship width (`time dp ...`);
 18. the last modules ported (slice16_phase; `--slice16-only` builds and
     runs it alone): the host Soft-NMS (ops/nms_host.py, the C scan of
     native/nms1d.c built with gcc) against the single-class kernel on the
     (6400, 1024) per-class rows for the hard, linear and Gaussian weights
     (`check nms_host@...` lines: the rows compared and those that differ);
     the bench (tools/bench.py) with eval at fp32 B=64 under the candidate
     cap 2000 and train at the root bench's B=64 in bf16, its FLOP counts,
     MFUs and vs_baseline positive, the train half's peak memory; the
     accuracy-cost tool for 30 epochs on 32 synthetic videos, fp32_exact
     served through the fp32 kernels and bf16_exact through the bf16 ones,
     fp32_exact above 0 and bf16_exact within 0.01 of it; the kernels of
     the bench's and the tool's paths counted from 0 around each;
 12. (last) where the device time of one call goes, kernel by kernel
     (torch.profiler: each kernel's launches and ms, `launches ...` lines):
     the CSP forward at T=224 and T=7 (2B=128), the whole-block TBlock
     forward at (64, 224, 512) and (8, 224, 512), the CSP backward at the
     train protocol's T=224 and T=7 (2B=16), the TBlock and the MHCA
     backward at (8, 224, 512), and phase 15's bf16 MHCA (64, 224, 512),
     CSP (T=224 with 4 heads, T=7) and whole-block TBlock (64, 224, 512)
     forwards (`launches mhca_bf16@...`, `launches csp_bf16@...`,
     `launches tblock_bf16@...`); each case's inputs drawn in phase 3, 6
     or 15, as the phase's own, and profiled after every timed phase, so
     that the profiler cannot touch their times.
The line before the last is a JSON object with one entry per kernel, the
eight fp32 kernels and the six bf16 ones (each redesigned bf16 kernel with
its `design`; with each fp32 kernel's
launches on the train CLI's path and on the dependency block's, and the
dependency shapes' checks and times; a bf16 forward kernel's launches are
on the bf16 served path, a bf16 backward kernel's on phase 16's train
steps and bf16 train CLI); the
last line is {"ok": true, "device": {...}}. It needs the repository beside
it and a CUDA device; without either it exits non-zero and prints no
result. With --bf16-fwd-only it builds and runs phase 15's kernel checks
and lines alone; with --bf16-train-only it builds and runs phase 16 alone; with
--bf16-profile-only, phase 16's profile of the bf16 backward kernels alone
(phase 16 runs it so, in a process of its own); with --dp-only (under
`python -m torch.distributed.run --standalone --nproc_per_node 1`) it builds
and runs phase 17 alone, without phase 13's run to compare the train CLI
with unless --phase13 names one; with --slice16-only it builds and runs
phase 18 alone.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 on the tensor cores
BF16_TOL = 8e-3              # a bf16 kernel vs its plain version, norm-wise
RTOL, ATOL = 1e-3, 1e-4      # fp32 with another summation order


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def compare(name, out, ref):
    """Max abs / rel error, raising beyond atol + rtol * |ref|."""
    import torch

    diff = (out - ref).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp(min=1e-6)).max())
    bad = int((diff > ATOL + RTOL * ref.abs()).sum())
    finite = bool(torch.isfinite(out).all())
    log(f"check {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"over_tol={bad} finite={finite}")
    if bad or not finite:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def bound_ms(flops: float, nbytes: float, tc_flops: float = 0.0):
    """(bound ms, what bounds it, FFMA-only bound ms): of `flops`, the
    `tc_flops` of products run in 3xTF32 (three TF32 passes at the tensor
    cores' peak), the rest on FFMA; the FFMA-only bound keeps rows
    comparable with the port's earlier FFMA kernels."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (3 * tc_flops / PEAK_TF32_FLOPS + (flops - tc_flops) / PEAK_FP32_FLOPS) * 1e3
    t_ffma = max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes)
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")) + (t_ffma,)


def mhca_flops(r, t, c):
    return 18 * r * t * c + mhca_products(r, t, c)


def mhca_products(r, t, c):
    """The MHCA's products (q/k/v/proj, QK^T, PV): 3xTF32 on the card."""
    return 8 * r * t * c * c + 4 * r * t * t * c


def mhca_case(model, key, r, t, c, gen, dev):
    import torch

    blk = dict(model.named_modules())[key]
    x1 = torch.randn(r, t, c, generator=gen).to(dev)
    x2 = x1 if key.endswith("attn") else torch.randn(r, t, c, generator=gen).to(dev)
    lengths = torch.randint(1, t + 1, (r,), generator=gen)
    lengths[1] = 0                                            # an all-masked row
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(dev)
    return (x1, x2, mask, *[w.detach().contiguous() for w in blk.packed_weights()])


def csp_case(model, key, r, t, gen, dev):
    import torch

    layer = dict(model.named_modules())[key]
    cin = layer.main_conv.conv.in_channels
    fg = layer.attn_block.guide_fc.in_features
    x = torch.randn(r, t, cin, generator=gen).to(dev)
    guide = torch.randn(r, 512, fg, generator=gen).to(dev)
    lengths = torch.randint(1, t + 1, (r,), generator=gen)
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(dev)
    packs = [b.packed_weights() for b in layer.blocks]
    ab = layer.attn_block
    ws = [layer.main_conv.conv.weight[:, :, 0], layer.main_conv.conv.bias,
          *[torch.stack([p[i] for p in packs]) for i in range(5)],
          ab.guide_fc.weight, ab.guide_fc.bias,
          torch.randn(ab.num_heads, generator=gen).to(dev),    # non-zero head bias
          ab.project_conv.conv.weight, ab.project_conv.conv.bias,
          layer.final_conv.conv.weight[:, :, 0], layer.final_conv.conv.bias]
    return (x, guide, mask, *[w.detach().contiguous() for w in ws]), ab.num_heads


def csp_flops(r, t, cin, mid, ng, fg, cout):
    return (3 * mhca_flops(r, t, mid) + 2 * r * t * cin * 2 * mid + 2 * r * ng * fg * mid
            + 2 * r * t * mid * ng + 6 * r * t * mid * mid + 2 * r * t * 6 * mid * cout)


def csp_products(r, t, cin, mid, ng, fg, cout):
    """The CSP layer's 3xTF32 products: every FLOP but the gate's scores and
    the MHCAs' conv + LayerNorm."""
    return csp_flops(r, t, cin, mid, ng, fg, cout) - 2 * r * t * mid * ng - 3 * 18 * r * t * mid


def mhca_bwd_flops(r, t, c):
    """Recompute + twice the products (the JAX package's executed-FLOP count
    of its backward kernel, pallas_fusion._record_flops)."""
    dense, attn = 8 * r * t * c * c, 4 * r * t * t * c
    return mhca_flops(r, t, c) + 2 * (dense + attn)


def csp_bwd_flops(r, t, cin, mid, ng, fg, cout):
    """pallas_csp._record_csp_flops: a forward recompute + twice the products."""
    mhca = 3 * (8 * r * t * mid * mid + 4 * r * t * t * mid)
    dense = (2 * r * t * cin * 2 * mid + 2 * r * ng * fg * mid + 2 * r * t * mid * ng
             + 6 * r * t * mid * mid + 2 * r * t * 6 * mid * cout)
    return csp_flops(r, t, cin, mid, ng, fg, cout) + 2 * (mhca + dense)


def check_grads(name, got, again, ref, n_inputs):
    """Input grads element-wise (compare), weight grads norm-wise <= 1e-4,
    and the two kernel runs bit for bit. Returns the max abs error of the
    input grads."""
    import torch

    err = max(compare(f"{name} d_in{i}", got[i], ref[i]) for i in range(n_inputs))
    worst = 0.0
    for i in range(n_inputs, len(ref)):
        rel = float((got[i] - ref[i]).norm() / ref[i].norm().clamp(min=1e-30))
        worst = max(worst, rel)
        if rel > 1e-4 or not bool(torch.isfinite(got[i]).all()):
            raise AssertionError(f"{name}: weight grad {i} off by {rel:.3e} (norm-wise)")
    same = all(bool((a == b).all()) for a, b in zip(got, again))
    log(f"check {name}: weight grads norm-wise max rel err {worst:.3e}, "
        f"bit-identical on repeat: {same}")
    if not same:
        raise AssertionError(f"{name}: two runs of the backward kernel differ")
    return err


# parameters whose only use is an argmax: no grad in the port, zero in JAX
ARGMAX_ONLY = {"alignment.fc_video_cls.weight", "alignment.fc_video_cls.bias",
               "alignment.fc_text_cls.weight", "alignment.fc_text_cls.bias"}


def tblock_case(model, key, r, t, gen, dev):
    """A stem block and its fused kernel's arguments at (r, t): random x and
    branch multipliers (the init scale of 1e-4 would hide both branches), a
    zero-length row, the block's packed weights."""
    import torch

    blk = dict(model.named_modules())[key]
    c = blk.ln11.weight.numel()
    x = torch.randn(r, t, c, generator=gen).to(dev)
    lengths = torch.randint(1, t + 1, (r,), generator=gen)
    lengths[1] = 0
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(dev)
    mult_a = (0.7 + 0.3 * torch.randn(r, 1, c, generator=gen)).to(dev)
    mult_m = (1.3 + 0.3 * torch.randn(r, 1, c, generator=gen)).to(dev)
    return blk, (x, mask, mult_a, mult_m,
                 *[w.detach().contiguous() for w in blk.packed_weights()])


def tblock_flops(r, t, c, hid):
    """pallas_tblock._record_tblock_flops: the MHCA plus the 4x MLP."""
    return mhca_flops(r, t, c) + 4 * r * t * c * hid


def tblock_bwd_flops(r, t, c, hid):
    """The recompute plus twice the products."""
    return tblock_flops(r, t, c, hid) + 2 * (8 * r * t * c * c + 4 * r * t * t * c
                                             + 4 * r * t * c * hid)


def set_stem(mode: str) -> None:
    """The whole-block TransformerBlock selector (models/blocks.py)."""
    from unav_yolyolva_tpu_torch.models import blocks

    blocks.FUSED_TBLOCK = mode


def kernel_profile(fn):
    """{kernel name: (launches, device ms)} of one call of fn (torch.profiler;
    copies and memsets not counted), after a warm-up profile of its own: the
    first profile of a process may come back without device events. An empty
    result means the profiler saw no kernel, and its caller says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unav_yolyolva_tpu_torch.utils.profiling import is_kernel

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return {e.key: (e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if is_kernel(e)}


def kernel_launches(fn) -> int:
    """CUDA kernels that one call of fn launches (kernel_profile); 0 where the
    profile came back empty."""
    return sum(n for n, _ in kernel_profile(fn).values())


def launches_text(n: int) -> str:
    return f"{n} kernels" if n else "the profile came back empty (no kernel seen)"


def launch_line(label, fn, smi):
    """One call of fn by kernel (kernel_profile): each kernel's launches and
    device ms, the longest first, as one `launches` line; returns the
    profile."""
    prof = kernel_profile(fn)
    rows = sorted(prof.items(), key=lambda kv: -kv[1][1])
    log(f"launches {label}: {launches_text(sum(c for c, _ in prof.values()))}, "
        f"{sum(ms for _, ms in prof.values()):.4f} ms of kernels (torch.profiler, one call); "
        + "; ".join(f"{k[:48]} x{c} {ms:.4f} ms" for k, (c, ms) in rows) + f" [{smi}]")
    return prof


def forward_launch_cases(model, gen, dev):
    """launch_lines' forward cases, as (label, call) pairs: one CSP forward at
    T=224 and T=7 (2B=128) and one whole-block TBlock forward at (64, 224,
    512) and (8, 224, 512) of the eval model."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock

    cases = []
    for label, key, t in (("csp@T224/4h", "backbone.fusion_module.top_down_layers.4", 224),
                          ("csp@T7/4h", "backbone.fusion_module.top_down_layers.1", 7)):
        a, heads = csp_case(model, key, 128, t, gen, dev)
        cases.append((label, lambda a=a, h=heads: fused_csp(*a, attn_heads=h)))
    for r in (64, 8):
        blk, a = tblock_case(model, "backbone.self_att_V.0", r, 224, gen, dev)
        cases.append((f"tblock@{r}x224x512",
                      lambda a=a, h=blk.attn.n_head: fused_tblock(*a, heads=h)))
    return cases


def backward_launch_cases(tmodel, b, t_max, gen, dev):
    """launch_lines' backward cases: one CSP backward at the train protocol's
    T=224 and T=7 (2B rows) and one whole-block TBlock backward at (B, T,
    512) of the train model."""
    import torch

    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward
    from unav_yolyolva_tpu_torch.ops.fused_tblock import tblock_backward

    cases = []
    for label, key, t in ((f"csp_bwd@T{t_max}", "backbone.fusion_module.bottom_up_layers.0",
                           t_max),
                          ("csp_bwd@T7", "backbone.fusion_module.bottom_up_layers.4", 7)):
        a, heads = csp_case(tmodel, key, 2 * b, t, gen, dev)
        g = torch.randn(2 * b, t, 512, generator=gen).to(dev)
        cases.append((f"{label}/{heads}h",
                      lambda a=a, g=g, h=heads: csp_backward(*a, g=g, attn_heads=h)))
    blk, a = tblock_case(tmodel, "backbone.self_att_V.0", b, t_max, gen, dev)
    g = torch.randn(b, t_max, 512, generator=gen).to(dev)
    cases.append((f"tblock_bwd@{b}x{t_max}x512",
                  lambda: tblock_backward(*a, g=g, heads=blk.attn.n_head)))
    return cases


def mhca_backward_launch_case(tmodel, b, t_max, gen, dev):
    """launch_lines' MHCA backward case at (B, T, 512) of the train model."""
    import torch

    from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward

    key = "backbone.self_att_V.0.attn"
    a = mhca_case(tmodel, key, b, t_max, 512, gen, dev)
    g = torch.randn(b, t_max, 512, generator=gen).to(dev)
    heads = dict(tmodel.named_modules())[key].n_head
    return f"mhca_bwd@{b}x{t_max}x512", lambda: mhca_backward(*a, g, heads=heads)


def launch_lines(cases, smi):
    """Where the device time of one call goes, kernel by kernel: launch_line
    over each (label, call) of cases, after every timed phase, so that the
    profiler cannot touch their times. The cases draw their inputs from the
    run's one generator in the phases they belong to: a draw moved to the
    end would change the inputs of every phase after its own."""
    for label, call in cases:
        launch_line(label, call, smi)


# launches a bf16 backward may make (the fused design's budget): a CSP layer's, and its
# attention backward's per MHCA (the kernels named attn_bwd_*, and the
# recompute's attention forward where the MHCA recomputes its output)
CSP_BWD_BF16_LAUNCHES, ATTN_BWD_BF16_LAUNCHES = 70, 3


def host_split_line(label, wrapper, prepare, entry, call, smi, n=20):
    """One bf16 backward's host work, medians of n calls: the whole wrapper
    (`wrapper`, the stream synchronised before and after), its C entry's
    enqueue alone (`entry` of the library that `prepare` returns with the
    entry's arguments; the wrapper's Python work is the first less the
    second); the kernels' device time (kernel_profile of `call`, the public
    entry) and the mean of n back-to-back calls (CUDA events)."""
    import torch

    from unav_yolyolva_tpu_torch.ops import cuda_build
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    def enqueue_ms(fn):          # host ms until fn returns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms

    wrap, enq = [], []
    for _ in range(n):
        wrap.append(enqueue_ms(wrapper))
        lib, args, *_ = prepare()
        enq.append(enqueue_ms(lambda: cuda_build.check(lib, getattr(lib, entry)(*args),
                                                       entry)))
    prof = kernel_profile(call)
    launches, dev_ms = sum(c for c, _ in prof.values()), sum(ms for _, ms in prof.values())
    wrap_ms, enq_ms = sorted(wrap)[n // 2], sorted(enq)[n // 2]
    log(f"host {label}: wrapper {wrap_ms:.4f} ms (its Python work {wrap_ms - enq_ms:.4f}, "
        f"the C entry's enqueue {enq_ms:.4f}), device {dev_ms:.4f} ms in "
        f"{launches_text(launches)}; back-to-back calls "
        f"{cuda_ms(call, n):.4f} ms a call "
        f"(host times medians of {n}, back-to-back the mean of {n}) [{smi}]")


def bf16_backward_profile(tmodel, b, t_max, gen, dev, smi):
    """Each bf16 backward kernel's launches at the protocol shape, by device
    time (launch_line over one call, after its timed runs): the kernels'
    names, calls and ms; then the CSP layer's launches at T=224 and T=7 held
    to CSP_BWD_BF16_LAUNCHES and its and the MHCA's attention backward to
    ATTN_BWD_BF16_LAUNCHES a MHCA (a profile that stays empty is said so,
    and fails the phase); at T=7 the CSP layer's host work (`host
    csp_bwd_bf16@T7/...`, host_split_line), and the whole-block TBlock's
    (`host tblock_bwd_bf16@...`: it encodes its products' tensor maps on
    the host each call)."""
    import torch

    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward
    from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward
    from unav_yolyolva_tpu_torch.ops import fused_csp, fused_tblock
    from unav_yolyolva_tpu_torch.ops.fused_tblock import tblock_backward

    bf = torch.bfloat16
    cases = []
    for key, t in (("backbone.fusion_module.top_down_layers.4", t_max),
                   ("backbone.fusion_module.bottom_up_layers.4", 7)):
        a, heads = csp_case(tmodel, key, 2 * b, t, gen, dev)
        ab = (a[0].to(bf), a[1].to(bf), *a[2:])
        gc = torch.randn(2 * b, t, 512, generator=gen).to(dev, bf)
        if t == 7:
            host_args = (ab, gc, heads)
        cases.append((f"csp_bwd_bf16@T{t}/{heads}h", 3,
                      lambda ab=ab, gc=gc, heads=heads: csp_backward(*ab, g=gc,
                                                                     attn_heads=heads)))
    m = mhca_case(tmodel, "backbone.self_att_V.0.attn", b, t_max, 512, gen, dev)
    mb = (m[0].to(bf), m[1].to(bf), *m[2:])
    gm = torch.randn(b, t_max, 512, generator=gen).to(dev, bf)
    nh = dict(tmodel.named_modules())["backbone.self_att_V.0.attn"].n_head
    cases.append((f"mhca_bwd_bf16@{b}x{t_max}x512", 1,
                  lambda: mhca_backward(*mb, gm, heads=nh)))
    blk, ta = tblock_case(tmodel, "backbone.self_att_V.0", b, t_max, gen, dev)
    gt = torch.randn(b, t_max, 512, generator=gen).to(dev)
    cases.append((f"tblock_bwd_bf16@{b}x{t_max}x512", 1,
                  lambda: tblock_backward(*ta, g=gt, heads=blk.attn.n_head, cdtype=bf)))
    for label, n_mhca, fn in cases:
        fn()
        torch.cuda.synchronize()
        prof = launch_line(label, fn, smi)
        total = sum(c for c, _ in prof.values())
        attn = sum(c for k, (c, _) in prof.items() if "attn" in k)
        log(f"attention {label}: {attn} of its launches attention kernels ({n_mhca} MHCA)")
        if not label.startswith("tblock"):
            require(total > 0, f"{label}: torch.profiler saw no kernel; launches not measured")
            require(attn <= ATTN_BWD_BF16_LAUNCHES * n_mhca,
                    f"{label}: {attn} attention launches, over {ATTN_BWD_BF16_LAUNCHES} a MHCA")
        if label.startswith("csp"):
            require(total <= CSP_BWD_BF16_LAUNCHES,
                    f"{label}: {total} launches, over {CSP_BWD_BF16_LAUNCHES}")
        if label.startswith("csp_bwd_bf16@T7/"):
            hab, hg, hh = host_args
            kw = dict(g=hg, attn_heads=hh, mhca_heads=4, eps=1e-5)
            host_split_line(label, lambda: fused_csp._launch_backward_bf16(*hab, **kw),
                            lambda: fused_csp._prepare_backward_bf16(*hab, **kw),
                            "unav_csp_bf16_backward",
                            lambda: fused_csp.csp_backward(*hab, **kw), smi)
        if label.startswith("tblock_bwd_bf16@"):
            targs = (*ta[:4], ta[4:], gt, blk.attn.n_head, 1e-5)
            host_split_line(label, lambda: fused_tblock._launch_backward_bf16(*targs),
                            lambda: fused_tblock._prepare_backward_bf16(*targs),
                            "unav_tblock_bf16_backward", cases[-1][2], smi)


def ran(step) -> int:
    """The steps of a train step that ran the kernel wrappers, whose launch
    counters count host calls: the eager and the captured ones; a replay of
    the captured CUDA graph calls no wrapper (train/step.py)."""
    return step.eager_steps + step.captures


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_detections(dets, batch, num_classes):
    import torch

    seg, sc, lab, ok = (dets[k].cpu() for k in ("segments", "scores", "labels", "valid"))
    dur = batch["duration"][:, None]
    require(torch.isfinite(seg).all() and torch.isfinite(sc).all(), "non-finite detections")
    require(((seg >= 0) & (seg <= dur[..., None])).all(), "segments outside [0, duration]")
    require(((lab >= 0) & (lab < num_classes)).all(), "labels out of range")
    s = torch.where(ok, sc, torch.full_like(sc, -1.0))
    require((s[:, 1:] <= s[:, :-1]).all(), "detections not sorted by score")
    require(not ok[-1].any(), "the zero-padded row has detections")
    return int(ok.sum())


def dets_agree(a, ref):
    """Per video of ref, whether detections a agree with it: the same valid
    slots, scores within rtol 1e-3, and the same labels and segments (within
    1e-3 s) on slots whose score is more than 1e-4 from its neighbours'
    (elsewhere a near-tie may swap two emissions). Returns (agree (V,), max
    score err, max segment err, unambiguous slots) over ref's valid slots."""
    import torch

    g = {k: v[: ref["valid"].shape[0]].cpu() for k, v in a.items()}
    r = {k: v.cpu() for k, v in ref.items()}
    ok = r["valid"]
    zero = torch.zeros_like(r["scores"])
    sdiff = torch.where(ok, (g["scores"] - r["scores"]).abs(), zero)
    rs = torch.where(ok, r["scores"], zero)
    d = (rs[:, 1:] - rs[:, :-1]).abs()
    inf = torch.full_like(rs[:, :1], float("inf"))
    sure = (torch.minimum(torch.cat([inf, d], 1), torch.cat([d, inf], 1)) > 1e-4) & ok
    gdiff = torch.where(sure[..., None], (g["segments"] - r["segments"]).abs(),
                        torch.zeros_like(r["segments"])).amax(-1)
    agree = ((g["valid"] == ok).all(1) & (sdiff <= 1e-6 + 1e-3 * rs.abs()).all(1)
             & ((g["labels"] == r["labels"]) | ~sure).all(1) & (gdiff <= 1e-3).all(1))
    return agree, float(sdiff.max()), float(gdiff.max()), int(sure.sum())


def compare_dets(got, ref, what="gpu-vs-cpu", probe=None, moved_by="a 1e-7 input perturbation"):
    """Detections of the same videos by two paths (dets_agree) must agree.
    With probe, a video may differ where its detections are not fixed at
    fp32 precision: probe() gives the detections of got's path for its
    inputs moved by one part in 1e7 in two opposite directions, and each
    video that differs must also move under one of them (a near-tie at a
    top-k, threshold or Soft-NMS pick decides it, as it does between two
    correct summation orders)."""
    import torch

    agree, err, seg_err, sure = dets_agree(got, ref)
    bad = ~agree
    moved = torch.zeros_like(bad)
    if bad.any() and probe is not None:
        for p in probe():
            moved |= ~dets_agree(p, {k: v[: bad.shape[0]] for k, v in got.items()})[0]
    require(bool((moved | agree).all()),
            f"{what}: videos {(bad & ~moved).nonzero().flatten().tolist()} differ (max score "
            f"err {err}, max segment err {seg_err} s) and do not move under {moved_by}")
    log(f"check {what} detections: videos={agree.shape[0]} "
        f"detections={int(ref['valid'].sum())} max_score_err={err:.3e} "
        f"max_segment_err_s={seg_err:.3e} unambiguous={sure}; videos differing "
        f"{int(bad.sum())}, each moving under {moved_by}")


def perturbed(batch, gen):
    """batch with its features moved by +1e-7 and by -1e-7 of themselves
    times one normal draw from gen: two batches."""
    import torch

    noise = {k: 1e-7 * torch.randn(batch[k].shape, generator=gen) for k in ("visual", "audio")}
    return [dict(batch, **{k: batch[k] * (1 + sign * n) for k, n in noise.items()})
            for sign in (1, -1)]


def check_step_grads(what, gpu_loss, gpu_g, cpu_loss, cpu_g):
    """One step's grads on the card against the CPU plain path: norm-wise
    <= 1e-3 per parameter tensor, the same parameters without a grad."""
    import torch

    none = {n for n, g in gpu_g.items() if g is None}
    require(none <= ARGMAX_ONLY and none == {n for n, g in cpu_g.items() if g is None},
            f"{what}: parameters without a grad: {sorted(none)}")
    zero = 1e-6 * max(float(g.norm()) for g in cpu_g.values() if g is not None)
    worst, worst_name = 0.0, ""
    for n, g in gpu_g.items():
        if g is None:
            continue
        ref = cpu_g[n]
        require(bool(torch.isfinite(g).all()), f"{n}: non-finite grad")
        if float(ref.norm()) < zero:         # exactly 0 in exact arithmetic
            require(float(g.norm()) < zero, f"{n}: grad should vanish")
            continue
        rel = float((g.cpu() - ref).norm() / ref.norm())
        if rel > worst:
            worst, worst_name = rel, n
    log(f"check {what} train grads: loss {gpu_loss:.6f} vs {cpu_loss:.6f}, "
        f"{len(gpu_g) - len(none)} tensors, worst norm-wise rel err {worst:.3e} "
        f"({worst_name}); no grad (argmax only): {sorted(none)}")
    require(worst <= 1e-3, f"{what}: GPU and CPU train grads differ")


def reference_checkpoint(model, path: str) -> None:
    """The model's weights as a reference-format `.pth.tar`: DataParallel's
    `module.` prefix, the EMA slot, and the alias slots of the shared
    instances (multiway 1, fusion downsample 1..4) as the reference holds
    them."""
    import torch

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for k in list(sd):
        if k.startswith("alignment.multiway_list.0."):
            sd[k.replace(".0.", ".1.", 1)] = sd[k]
        if k.startswith("backbone.fusion_module.downsample_layers.0."):
            for i in range(1, 5):
                sd[k.replace("layers.0.", f"layers.{i}.")] = sd[k]
    torch.save({"epoch": 0, "state_dict_ema": {"module." + k: v for k, v in sd.items()}}, path)


def serve_from_files(model, seed, dev, smi, reset_counts, counts) -> None:
    """Phase 4b: the eval CLI on feature files written at the flagship width
    (256 validation videos of 48-224 frames, 100 classes), with `model`'s
    weights in a reference `.pth.tar`: four batches of 64 through the
    Batcher's worker processes into pinned memory, the eval step's copy
    stream and valid_one_epoch's harvest; held bit for bit
    against make_eval_step fed the same batches as pageable numpy arrays;
    then the pipeline's videos/s beside the in-memory step's, one batch's
    copy pinned beside pageable, and the copy's overlap with compute."""
    import pickle
    import tempfile

    import numpy as np
    import torch
    import yaml

    from unav_yolyolva_tpu_torch.core import load_config
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset
    from unav_yolyolva_tpu_torch.eval import cli, make_eval_step
    from unav_yolyolva_tpu_torch.train import valid_one_epoch
    from unav_yolyolva_tpu_torch.utils.profiling import StepTimer, busy_and_overlap, trace
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        synth = make_synthetic_dataset(root, num_videos=256, num_classes=100, min_len=48,
                                       max_len=224, visual_dim=2048, audio_dim=128,
                                       val_fraction=1.0, seed=seed)
        nbytes = sum(e.stat().st_size for e in os.scandir(synth["feat_folder"]))
        with open(os.path.join(ROOT, "configs", "avel_unav100_eval.yaml")) as f:
            raw = yaml.safe_load(f)
        raw["test_split"] = ["validation"]
        raw["dataset"].update(json_file=synth["json_file"], feat_folder=synth["feat_folder"])
        cfg_yaml = os.path.join(root, "eval.yaml")
        with open(cfg_yaml, "w") as f:
            yaml.safe_dump(raw, f)
        ckpt = os.path.join(root, "model_best.pth.tar")
        reference_checkpoint(model, ckpt)
        log(f"serve from files: 256 videos, {nbytes / 1e6:.1f} MB of .npy features and a "
            f"reference .pth.tar written in {time.perf_counter() - t_phase:.1f} s")

        reset_counts()
        mAP = cli.main(cli.parse_args([cfg_yaml, ckpt, "--print-freq", "1000"]))
        torch.cuda.synchronize()
        got = counts()
        log(f"serve from files: eval CLI average mAP {mAP!r}, kernel launches {got}")
        require(math.isfinite(mAP) and 0.0 <= mAP <= 1.0, f"mAP {mAP} not in [0, 1]")
        require(got["mhca"] >= 20 and got["csp"] == 40 and got["nms"] == 4,
                f"the CLI did not run through every kernel of the path: {got}")

        cli.main(cli.parse_args([cfg_yaml, ckpt, "--saveonly", "--print-freq", "1000"]))
        with open(os.path.join(root, "eval_results.pkl"), "rb") as f:
            piped = pickle.load(f)
        cfg = load_config(cfg_yaml)
        ds = UnAV100Dataset(False, cfg["test_split"], **cfg["dataset"])
        step = make_eval_step(model, cfg, device=dev)
        with make_batcher(ds, cfg, False, device="cpu") as batcher:
            plain = list(batcher)                                     # numpy, pageable
        ref_file = os.path.join(root, "in_memory.pkl")
        valid_one_epoch(model, plain, step, -1, output_file=ref_file, print_freq=1000)
        with open(ref_file, "rb") as f:
            ref = pickle.load(f)
        same = list(piped["video-id"]) == list(ref["video-id"]) and all(
            piped[k].dtype == ref[k].dtype and np.array_equal(piped[k], ref[k])
            for k in ("t-start", "t-end", "label", "score"))
        log(f"check serve-from-files detections: {len(ref['video-id'])} detections of 256 "
            f"videos, the CLI's (pinned batches, copy stream) bit-identical to in-memory "
            f"make_eval_step's on pageable numpy batches: {same}")
        require(same, "the CLI's detections differ from the in-memory step's")

        piped_batcher = make_batcher(ds, cfg, False, device=dev)       # workers kept
        arrivals = []

        class Stamped:
            """The pinned batcher, each batch's arrival at the loop noted."""

            def __len__(self):
                return len(piped_batcher)

            def __iter__(self):
                for b in piped_batcher:
                    arrivals.append(time.perf_counter())
                    yield b

        def pipeline():
            """(whole-epoch videos/s, videos/s after the first batch arrived)."""
            arrivals.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            valid_one_epoch(model, Stamped(), step, -1, output_file=ref_file, print_freq=1000)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            return 256 / (t1 - t0), 64 * (len(arrivals) - 1) / (t1 - arrivals[0])

        def in_memory():
            for b in plain:
                step(b)

        pipeline()                      # warm-up: the workers start, the pinned ring fills
        pipeline()
        timer = StepTimer()
        rates = {"pipeline": [], "in_memory": []}
        for name in ("pipeline", "in_memory", "in_memory", "pipeline"):      # in turns
            rates[name].append(pipeline() if name == "pipeline"
                               else 256 / timer.time_fn(in_memory))
        log(f"time serve pipeline (files in the page cache -> 4 worker processes -> shared "
            f"memory -> pinned -> copy stream -> step -> harvest, 4 batches of 64): "
            f"{[round(r[0], 1) for r in rates['pipeline']]} videos/s over the epoch, "
            f"{[round(r[1], 1) for r in rates['pipeline']]} videos/s after the first batch "
            f"[{smi}]")
        log(f"time serve in_memory (make_eval_step on numpy batches in memory, pageable "
            f"copy): {[round(r, 1) for r in rates['in_memory']]} videos/s [{smi}]")

        for pinned in piped_batcher:
            break
        keys = ("visual", "audio", "mask", "fps", "duration", "feat_stride", "feat_num_frames")
        mb = sum(pinned[k].numel() * pinned[k].element_size() for k in keys) / 1e6
        side = torch.cuda.Stream()

        def copy_pinned():
            with torch.cuda.stream(side):
                out = [pinned[k].to(dev, non_blocking=True) for k in keys]
            torch.cuda.current_stream().wait_stream(side)
            return out

        pin_ms = cuda_ms(copy_pinned, 5)
        page_ms = cuda_ms(lambda: [torch.as_tensor(plain[0][k]).to(dev) for k in keys], 5)
        log(f"time copy of one batch of 64 ({mb:.1f} MB): pinned, non_blocking on a copy "
            f"stream {pin_ms:.3f} ms ({mb / pin_ms:.2f} GB/s); pageable numpy "
            f"{page_ms:.3f} ms ({mb / page_ms:.2f} GB/s) [{smi}]")

        torch.cuda.synchronize()
        with trace() as prof:
            t0 = time.perf_counter()
            pipeline()
            wall = time.perf_counter() - t0
        piped_batcher.close()
        busy, copy_ms, under = busy_and_overlap(prof, wall)
        log(f"overlap serve pipeline (torch.profiler, 4 batches): host-to-device copies "
            f"{copy_ms:.2f} ms, {100 * under:.1f}% of that time under a kernel; busy share "
            f"{busy:.3f}; the copy overlaps compute: {'yes' if under > 0 else 'no'} [{smi}]")
    log(f"serve-from-files phase: {time.perf_counter() - t_phase:.1f} s")


def host_ms(fn) -> float:
    """Host ms of one call of fn between two synchronizations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def finite_losses(losses) -> bool:
    return bool(losses) and all(math.isfinite(float(v)) for v in losses.values())


def phase13_files(root: str, seed: int) -> str:
    """Phase 13's feature files (64 train clips and 64 validation videos of
    48-224 frames at the flagship width, 100 classes) written under root,
    and its config over them (configs/avel_unav100.yaml with paths, 2 + 1
    epochs and eval_freq 1); returns the config's path. Phase 17 writes the
    same files from the same seed."""
    import yaml

    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset

    synth = make_synthetic_dataset(root, num_videos=128, num_classes=100, min_len=48,
                                   max_len=224, visual_dim=2048, audio_dim=128,
                                   val_fraction=0.5, seed=seed + 13)
    with open(os.path.join(ROOT, "configs", "avel_unav100.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["dataset"].update(json_file=synth["json_file"], feat_folder=synth["feat_folder"])
    raw.update(train_split=["train"], val_split=["validation"], test_split=["validation"],
               output_folder=os.path.join(root, "ckpt"))
    raw["opt"].update(epochs=2, warmup_epochs=1)
    raw["train_cfg"]["eval_freq"] = 1
    cfg_yaml = os.path.join(root, "train.yaml")
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump(raw, f)
    return cfg_yaml


def train_from_files(seed, dev, smi, reset_counts, counts, keep=None) -> dict:
    """Phase 13: the train CLI on feature files written at the flagship
    width (64 train clips and 64 validation videos of 48-224 frames, 100
    classes): configs/avel_unav100.yaml with its paths, epochs (2 + 1 of
    warmup) and eval_freq (1) overridden, -c 1, B=8: 8 steps an epoch through
    the pinned Batcher and the train step's copy stream, the EMA validated
    with its losses after every epoch, then the final pass on model_best's
    raw weights. Then `--resume epoch_001` trains epoch 2 again, whose
    epoch_002 weights are held against the straight run's; one step's
    grads taken twice name any op that is not deterministic. Then, as
    information: clips/s from files beside the in-memory step's, one batch's
    copy pinned beside pageable, and the copies' share under a kernel.
    With `keep` (a directory), the straight run's epoch_002/state.pt and its
    mAPs (maps.json) are copied there for phase 17. Returns the launches of
    the CLI's run."""
    import tempfile

    import torch

    from unav_yolyolva_tpu_torch.core import load_config
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.tools.grad_gaps import step_grads
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms
    from unav_yolyolva_tpu_torch.train import (cli, create_train_state, make_optimizer,
                                               make_train_step, train_one_epoch)
    from unav_yolyolva_tpu_torch.train.step import BATCH_KEYS
    from unav_yolyolva_tpu_torch.utils.profiling import StepTimer, busy_and_overlap, trace

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        cfg_yaml = phase13_files(root, seed)
        log(f"train from files: 64 train clips and 64 validation videos written in "
            f"{time.perf_counter() - t_phase:.1f} s")

        reset_counts()
        t0 = time.perf_counter()
        out = cli.main(cli.parse_args([cfg_yaml, "-p", "4", "-c", "1", "--output", "straight"]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = counts()
        hist, ts = out["history"], out["train_steps"]
        log(f"train from files: the train CLI, 3 epochs of 8 steps at B=8 in {secs:.1f} s, "
            f"kernel launches {got}, train steps {ts}")
        for h in hist:
            log(f"train from files: epoch {h['epoch']} train losses "
                f"{ {k: round(v, 5) for k, v in h['train_losses'].items()} }, mAP "
                f"{h['mAP']!r}, validation losses "
                f"{ {k: round(v, 5) for k, v in (h['val_losses'] or {}).items()} }")
        log(f"train from files: best mAP {out['best_mAP']!r}, final pass on model_best's raw "
            f"weights {out['final_mAP']!r}")
        require(len(hist) == 3 and all(finite_losses(h["train_losses"]) for h in hist),
                "train from files: a non-finite train loss")
        require(all(finite_losses(h["val_losses"]) for h in hist),
                "train from files: validation losses empty or non-finite")
        maps = [h["mAP"] for h in hist] + [out["final_mAP"]]
        require(all(m is not None and math.isfinite(m) and 0.0 <= m <= 1.0 for m in maps),
                f"train from files: mAP {maps} not in [0, 1]")
        folder = out["ckpt_folder"]
        have = sorted(os.listdir(folder))
        require({"model_best", "epoch_001", "epoch_002"} <= set(have),
                f"train from files: checkpoints {have}")
        if keep is not None:
            shutil.copy(os.path.join(folder, "epoch_002", "state.pt"), keep)
            with open(os.path.join(keep, "maps.json"), "w") as f:
                json.dump({"mAPs": [h["mAP"] for h in hist], "final_mAP": out["final_mAP"],
                           "best_mAP": out["best_mAP"]}, f)
        # 24 steps, of which the eager and the captured one run the
        # wrappers (the rest replay the graph): 5 MHCA and 10 CSP a step,
        # forward and backward; 4 validations of 8 batches: 10 CSP and one
        # merged NMS a batch
        n = ts["eager"] + ts["captured"]
        # the captured step replays too: 1 eager step and 23 replays
        require(ts == {"eager": 1, "captured": 1, "replayed": 23},
                f"train from files: train steps {ts}, not 1 eager, 1 captured, 23 replayed")
        require(got["mhca_bwd"] == 5 * n and got["csp_bwd"] == 10 * n
                and got["csp"] == 10 * (n + 32) and got["nms"] == 32
                and got["mhca"] == 5 * (n + 32),
                f"train from files: the CLI did not run through every kernel: {got}")

        t0 = time.perf_counter()
        cli.main(cli.parse_args([cfg_yaml, "-p", "4", "-c", "1", "--output", "resumed",
                                 "--resume", os.path.join(folder, "epoch_001")]))
        log(f"train from files: resumed from epoch_001, epoch 2 again in "
            f"{time.perf_counter() - t0:.1f} s")
        a = torch.load(os.path.join(folder, "epoch_002", "state.pt"), map_location="cpu")
        b = torch.load(os.path.join(folder.replace("_straight", "_resumed"), "epoch_002",
                                    "state.pt"), map_location="cpu")
        same = [k for k in a["model"] if torch.equal(a["model"][k], b["model"][k])]
        gaps = {k: float((a["model"][k] - b["model"][k]).norm()
                         / a["model"][k].norm().clamp(min=1e-30)) for k in a["model"]}
        worst = max(gaps, key=gaps.get)
        log(f"check resume: epoch_002 of the resumed run against the straight run: "
            f"{len(same)} of {len(gaps)} parameter tensors bit-identical; largest norm-wise "
            f"gap {gaps[worst]:.3e} ({worst})")

        cfg = load_config(cfg_yaml)
        ds = UnAV100Dataset(True, cfg["train_split"], **cfg["dataset"])
        cfg["train_cfg"]["head_empty_cls"] = ds.get_attributes()["empty_label_ids"]
        cfg["model"]["train_cfg"] = cfg["train_cfg"]
        with make_batcher(ds, cfg, True, seed=seed, device="cpu") as cpu_batcher:
            plain = [{k: torch.as_tensor(v) for k, v in bt.items() if k != "video_id"}
                     for bt in cpu_batcher]                           # numpy -> pageable
        # which op is not deterministic: one step's grads taken twice, with
        # cuDNN's default algorithms and with its deterministic ones (the
        # CLI's setting, the reference's fix_random_seed)
        probe = build_model(cfg, device=dev, seed=seed)
        for mod in probe.modules():
            if hasattr(mod, "drop_prob"):
                mod.drop_prob = 0.0
        differ = {}
        for flag in (False, True):
            torch.backends.cudnn.deterministic = flag
            g1 = step_grads(copy.deepcopy(probe), cfg, plain[0], dev)[1]
            g2 = step_grads(copy.deepcopy(probe), cfg, plain[0], dev)[1]
            differ[flag] = sorted(n for n, g in g1.items()
                                  if g is not None and not torch.equal(g, g2[n]))
            convs = [n for n in differ[flag] if n.endswith("conv.weight")]
            log(f"check determinism (cudnn.deterministic={flag}): one train step's grads "
                f"taken twice on the card: {len(differ[flag])} of {len(g1)} tensors differ, "
                f"among them {len(convs)} conv weights, e.g. {convs[:3]}")
        del probe, g1, g2
        require(not differ[True], "the train step is not deterministic with cuDNN's "
                                  f"deterministic algorithms: {differ[True][:8]}")
        require(len(same) == len(gaps) or gaps[worst] <= 1e-5,
                f"train from files: the resumed run's epoch_002 is {gaps[worst]:.3e} off "
                f"({worst})")

        model = build_model(cfg, device=dev, seed=seed)
        optimizer, _ = make_optimizer(model, cfg["opt"], len(plain),
                                      cfg["train_cfg"]["clip_grad_l2norm"])
        state = create_train_state(model, optimizer, cfg["train_cfg"]["init_loss_norm"])
        step = make_train_step(model, optimizer, cfg, device=dev)
        piped = make_batcher(ds, cfg, True, seed=seed, device=dev)
        arrivals = []

        class Stamped:
            """The pinned batcher, each batch's arrival at the loop noted."""

            def __len__(self):
                return len(piped)

            def set_epoch(self, epoch):
                piped.set_epoch(epoch)

            def __iter__(self):
                for bt in piped:
                    arrivals.append(time.perf_counter())
                    yield bt

        def pipeline():
            """(whole-epoch clips/s, clips/s after the first batch arrived)."""
            arrivals.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_one_epoch(state, Stamped(), step, seed, 0, print_freq=1000,
                            log=lambda *a: None)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n = 8 * len(arrivals)
            return n / (t1 - t0), 8 * (len(arrivals) - 1) / (t1 - arrivals[0])

        def in_memory():
            for bt in plain:
                step(state, bt, seed)

        torch.backends.cudnn.deterministic = True                  # as the CLI trains
        pipeline()
        timer = StepTimer()
        rates = {"pipeline": [], "in_memory": [], "in_memory_cudnn_default": []}
        for name in ("pipeline", "in_memory", "in_memory_cudnn_default",
                     "in_memory_cudnn_default", "in_memory", "pipeline"):     # in turns
            torch.backends.cudnn.deterministic = name != "in_memory_cudnn_default"
            rates[name].append(pipeline() if name == "pipeline"
                               else 8 * len(plain) / timer.time_fn(in_memory))
        torch.backends.cudnn.deterministic = True
        log(f"time train pipeline (files -> 4 worker processes -> shared memory -> pinned "
            f"-> copy stream -> train step, 8 steps of 8 clips, cuDNN deterministic): "
            f"{[round(r[0], 1) for r in rates['pipeline']]} clips/s over the epoch, "
            f"{[round(r[1], 1) for r in rates['pipeline']]} clips/s after the first batch "
            f"[{smi}]")
        log(f"time train in_memory (make_train_step on batches in memory, pageable copy): "
            f"{[round(r, 1) for r in rates['in_memory']]} clips/s with cuDNN deterministic, "
            f"{[round(r, 1) for r in rates['in_memory_cudnn_default']]} with its default "
            f"algorithms [{smi}]")

        for pinned in piped:
            break
        mb = sum(pinned[k].numel() * pinned[k].element_size() for k in BATCH_KEYS) / 1e6
        side = torch.cuda.Stream()

        def copy_pinned():
            with torch.cuda.stream(side):
                moved = [pinned[k].to(dev, non_blocking=True) for k in BATCH_KEYS]
            torch.cuda.current_stream().wait_stream(side)
            return moved

        pin_ms = cuda_ms(copy_pinned, 5)
        page_ms = cuda_ms(lambda: [plain[0][k].to(dev) for k in BATCH_KEYS], 5)
        log(f"time copy of one train batch of 8 ({mb:.1f} MB): pinned, non_blocking on a "
            f"copy stream {pin_ms:.3f} ms ({mb / pin_ms:.2f} GB/s); pageable "
            f"{page_ms:.3f} ms ({mb / page_ms:.2f} GB/s) [{smi}]")
        torch.cuda.synchronize()
        with trace() as prof:
            t0 = time.perf_counter()
            pipeline()
            wall = time.perf_counter() - t0
        piped.close()
        torch.backends.cudnn.deterministic = False      # the other phases' setting
        busy, copy_ms, under = busy_and_overlap(prof, wall)
        log(f"overlap train pipeline (torch.profiler, 8 steps): host-to-device copies "
            f"{copy_ms:.2f} ms, {100 * under:.1f}% of that time under a kernel; busy share "
            f"{busy:.3f} [{smi}]")
    log(f"train-from-files phase: {time.perf_counter() - t_phase:.1f} s")
    return got


def dependency_case(n, t, long_rows, gen, dev):
    """A dependency branch's inputs at its protocol shape: (x1, x2, mask) of
    n samples over rows of length t. The temporal branch (long_rows False):
    n * 100 rows of the n samples' frame masks tiled c-major; the
    co-occurrence branch: n * 224 rows of 100 classes, a padded frame's row
    fully masked. The first sample is full, the others 16..224 frames."""
    import torch

    lengths = torch.randint(16, 225, (n,), generator=gen)
    lengths[0] = 224
    frames = torch.arange(224)[None, :] < lengths[:, None]                 # (n, 224)
    if long_rows:
        mask = frames.reshape(-1, 1).expand(-1, t).contiguous()           # (n*224, 100)
    else:
        mask = frames.repeat(100, 1)                                      # (100n, 224)
    r = mask.shape[0]
    x1 = torch.randn(r, t, 128, generator=gen)
    x2 = torch.randn(r, t, 128, generator=gen)
    return x1.to(dev), x2.to(dev), mask.to(dev)


def conv3_lines(model, dev, smi, gen, results) -> None:
    """The dependency block's two k=3 convs on their kernel (ops/conv3_tc.py)
    alone, with the block's weights, at level 0 (T=224) and level 5 (T=7)
    of a batch of 64 with padded rows: the error against fp64 within 2x
    that of cuDNN's fp32 conv (TF32 off), the same bits on repeat, and the
    time (CUDA events) beside the 3xTF32 and FFMA bounds, the plain
    version, cuDNN's fp32 conv1d (library_ms: what the block ran before)
    and the port's mma.sync product with its k=3 tap loader
    (tf32x3_linear(taps=3)); results[conv3@...] = (err, ms, plain ms,
    bound ms, what bounds it, FFMA bound ms, library ms, tf32x3_linear ms)."""
    import torch
    import torch.nn.functional as F

    from unav_yolyolva_tpu_torch.ops.conv3_tc import (conv3_split, masked_conv3,
                                                      masked_conv3_reference)
    from unav_yolyolva_tpu_torch.ops.gemm_tc import conv3_taps, tf32x3_linear
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    dep = model.dependency
    for name, conv, relu in (("expand", dep.feature_expand, True),
                             ("squeeze", dep.feature_squeeze, False)):
        w = conv.conv.weight.detach()
        n, kc, _ = w.shape
        for lvl in (0, 5):
            t = 224 >> lvl
            x = torch.randn(64, t, kc, generator=gen).to(dev)
            lengths = torch.randint(1, t + 1, (64,), generator=gen)
            lengths[0] = t
            mask = (torch.arange(t)[None, :] < lengths[:, None]).to(dev)
            split = conv3_split(w)
            with torch.inference_mode():
                y = masked_conv3([x], w, [mask], relu=relu, split=split)[0]
                again = masked_conv3([x], w, [mask], relu=relu, split=split)[0]
                a = conv3_taps(x.reshape(64 * t, kc).double(), t)
                ref = a @ w.double().permute(0, 2, 1).reshape(n, 3 * kc).T
                del a
                ref = ((ref.clamp_min(0) if relu else ref) * mask.reshape(-1, 1)).reshape(y.shape)
                y32 = F.conv1d(x.transpose(1, 2), w, padding=1).transpose(1, 2)
                y32 = (y32.clamp_min(0) if relu else y32) * mask[..., None]
                err = float((y.double() - ref).norm() / ref.norm())
                err32 = float((y32.double() - ref).norm() / ref.norm())
                del ref, y32
                label = f"conv3@{name}/64x{t}x{kc}->{n}"
                log(f"check {label}: rel err vs fp64 {err:.3e} (cuDNN fp32 {err32:.3e}), masked "
                    f"rows zero {bool((y[~mask] == 0).all())}")
                require(err <= 2 * err32 and torch.equal(y, again) and bool((y[~mask] == 0).all()),
                        f"{label}: error above 2x fp32's, another result on repeat, or a masked "
                        f"row not 0")
                ms = cuda_ms(lambda: masked_conv3([x], w, [mask], relu=relu, split=split), 10)
                split_ms = cuda_ms(lambda: conv3_split(w), 10)
                lib_ms = cuda_ms(lambda: F.conv1d(x.transpose(1, 2), w, padding=1), 10)
                xm, wk = x.reshape(64 * t, kc), w.permute(0, 2, 1).reshape(n, 3 * kc).contiguous()
                tc_ms = cuda_ms(lambda: tf32x3_linear(xm, wk, taps=3, seq=t), 10)
                pms = cuda_ms(lambda: masked_conv3_reference(x, w, mask, relu), 1, warmup=1)
            flops = 2 * 64 * t * n * 3 * kc
            nbytes = 4 * (64 * t * (kc + n) + 2 * n * 3 * kc) + 64 * t
            bms, by, ffma = bound_ms(flops, nbytes, flops)
            results[label] = (err, ms, pms, bms, by, ffma, lib_ms, tc_ms)
            log(f"time {label}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), bound "
                f"{bms:.3f} ms ({by}, 3xTF32) / FFMA {ffma:.3f} ms; plain {pms:.3f} ms; "
                f"library_ms (cuDNN fp32 conv1d) {lib_ms:.3f} ms; tf32x3_linear(taps=3) "
                f"{tc_ms:.3f} ms; the weight's split {split_ms:.3f} ms [{smi}]")
            del x, y, again, xm, wk
            torch.cuda.empty_cache()
    # the six levels as the block runs them: a launch a level for the
    # expanding conv, one over every level for the squeezing conv
    xs = {name: [torch.randn(64, 224 >> lvl, kc, generator=gen).to(dev) for lvl in range(6)]
          for name, kc in (("expand", 1024), ("squeeze", 12800))}
    masks = [torch.ones(64, 224 >> lvl, dtype=torch.bool, device=dev) for lvl in range(6)]
    w_in, w_out = dep.feature_expand.conv.weight.detach(), dep.feature_squeeze.conv.weight.detach()
    with torch.inference_mode():
        s_in = conv3_split(w_in)
        e_ms = cuda_ms(lambda: [masked_conv3([x], w_in, [m], relu=True, split=s_in)
                                for x, m in zip(xs["expand"], masks)], 5)
        q_ms = cuda_ms(lambda: masked_conv3(xs["squeeze"], w_out, masks, relu=False), 5)
        q1_ms = cuda_ms(lambda: [masked_conv3([x], w_out, [m], relu=False)
                                 for x, m in zip(xs["squeeze"], masks)], 5)
    flops = 2 * 64 * sum(224 >> lvl for lvl in range(6)) * 12800 * 3 * 1024
    log(f"time conv3 block (6 levels, B=64): expand a launch a level {e_ms:.3f} ms "
        f"({flops / e_ms / 1e9:.1f} TFLOP/s); squeeze in one launch {q_ms:.3f} ms "
        f"({flops / q_ms / 1e9:.1f} TFLOP/s, a launch a level {q1_ms:.3f} ms, its split "
        f"included) [{smi}]")


def dependency_phase(seed, dev, smi, gen, reset_counts, counts, results) -> dict:
    """Phase 14: the dependency block (use_dependency: True). The MHCA
    kernel (one head of width 128) against its plain version at the
    branches' shapes, forward at the train (B=8) and eval (B=64) protocols
    and backward at the train protocol; the whole-block TBlock kernel at
    hidden = C = 128 the same way; exact zeros on the fully masked rows, the
    same bits on repeat. Then one batch of 64 served with the dependency
    block (default and whole-block stem, the first two videos held against
    the CPU path), two train steps at B=8, and the block's time in a batch
    and in a step, the expand and squeeze convs' share, the peak memory.
    Returns the launches of the served batch and of the train steps."""
    import torch

    from unav_yolyolva_tpu_torch.core import load_config
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch, synthetic_train_batch
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_mhca import (fused_mhca, mhca_backward,
                                                        mhca_backward_reference,
                                                        mhca_reference)
    from unav_yolyolva_tpu_torch.ops.conv3_tc import conv3_split, masked_conv3
    from unav_yolyolva_tpu_torch.ops.fused_tblock import (fused_tblock, tblock_backward,
                                                          tblock_backward_reference,
                                                          tblock_reference)
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100_eval.yaml"))
    cfg["model"]["use_dependency"] = True
    model = build_model(cfg, device=dev, seed=seed)
    dep = model.dependency
    log(f"dependency: model with the dependency block, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters "
        f"({sum(p.numel() for p in dep.parameters()) / 1e6:.2f} M in the block)")
    c = 128
    cases = (("temporal", dep.temporal_branch, 8, 224, False, True),
             ("cooccur", dep.cooccur_branch, 8, 100, True, True),
             ("temporal", dep.temporal_branch, 64, 224, False, False),
             ("cooccur", dep.cooccur_branch, 64, 100, True, False))
    new = {"mhca": [], "mhca_bwd": [], "tblock": [], "tblock_bwd": []}
    for name, blk, n, t, long_rows, train in cases:
        x1, x2, mask = dependency_case(n, t, long_rows, gen, dev)
        r = x1.shape[0]
        dead = ~mask.any(1)
        attn = [w.detach().contiguous() for w in blk.attn.packed_weights()]
        label = f"mhca@{r}x{t}x{c}/1h"
        with torch.inference_mode():
            out = fused_mhca(x1, x2, mask, *attn, heads=1)
            err = compare(f"{label} ({name})", out, mhca_reference(x1, x2, mask, *attn, heads=1))
            require(bool((out[dead] == 0).all()) and torch.equal(
                out, fused_mhca(x1, x2, mask, *attn, heads=1)),
                f"{label}: fully masked rows not exactly 0, or another result on repeat")
            ms = cuda_ms(lambda: fused_mhca(x1, x2, mask, *attn, heads=1), 10)
            pms = cuda_ms(lambda: mhca_reference(x1, x2, mask, *attn, heads=1), 3)
        nbytes = 4 * (3 * r * t * c + 4 * c * c + 19 * c) + r * t
        results[label] = (err, ms, pms, *bound_ms(mhca_flops(r, t, c), nbytes,
                                                  mhca_products(r, t, c)))
        new["mhca"].append(label)
        log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
            f"{results[label][3]:.3f} ms ({results[label][4]}); fully masked rows "
            f"{int(dead.sum())} of {r} [{smi}]")
        if train:
            g = torch.randn(r, t, c, generator=gen).to(dev)
            got = mhca_backward(x1, x2, mask, *attn, g, heads=1)
            again = mhca_backward(x1, x2, mask, *attn, g, heads=1)
            ref = mhca_backward_reference(x1, x2, mask, *attn, g, heads=1)
            blabel = f"mhca_bwd@{r}x{t}x{c}/1h"
            err = check_grads(f"{blabel} ({name})", got, again, ref, 2)
            require(all(bool((d[dead] == 0).all()) for d in got[:2]),
                    f"{blabel}: a fully masked row got a non-zero input grad")
            ms = cuda_ms(lambda: mhca_backward(x1, x2, mask, *attn, g, heads=1), 10)
            pms = cuda_ms(lambda: mhca_backward_reference(x1, x2, mask, *attn, g, heads=1), 3)
            nbytes = 4 * (5 * r * t * c + 2 * (4 * c * c + 19 * c)) + r * t
            flops = mhca_bwd_flops(r, t, c)
            results[blabel] = (err, ms, pms, *bound_ms(flops, nbytes, flops - 18 * r * t * c))
            new["mhca_bwd"].append(blabel)
            log(f"time {blabel}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                f"{results[blabel][3]:.3f} ms ({results[blabel][4]}) [{smi}]")
            del g, got, again, ref

        # the whole block at hidden = C: its own x, multipliers, weights
        mult_a = (0.7 + 0.3 * torch.randn(r, 1, c, generator=gen)).to(dev)
        mult_m = (1.3 + 0.3 * torch.randn(r, 1, c, generator=gen)).to(dev)
        a = (x1, mask, mult_a, mult_m, *[w.detach().contiguous() for w in blk.packed_weights()])
        hid = a[11].shape[0]
        label = f"tblock@{r}x{t}x{c}/h{hid}"
        with torch.inference_mode():
            out = fused_tblock(*a, heads=1)
            err = compare(f"{label} ({name})", out, tblock_reference(*a, heads=1))
            require(bool((out[dead] == 0).all()) and torch.equal(out, fused_tblock(*a, heads=1)),
                    f"{label}: fully masked rows not exactly 0, or another result on repeat")
            ms = cuda_ms(lambda: fused_tblock(*a, heads=1), 10)
            pms = cuda_ms(lambda: tblock_reference(*a, heads=1), 3)
        nbytes = 4 * (2 * r * t * c + 2 * r * c + sum(w.numel() for w in a[4:])) + r * t
        results[label] = (err, ms, pms, *bound_ms(tblock_flops(r, t, c, hid), nbytes,
                                                  mhca_products(r, t, c) + 4 * r * t * c * hid))
        new["tblock"].append(label)
        log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
            f"{results[label][3]:.3f} ms ({results[label][4]}) [{smi}]")
        if train:
            g = torch.randn(r, t, c, generator=gen).to(dev)
            got = tblock_backward(*a, g=g, heads=1)
            again = tblock_backward(*a, g=g, heads=1)
            ref = tblock_backward_reference(*a, g=g, heads=1)
            blabel = f"tblock_bwd@{r}x{t}x{c}/h{hid}"
            err = check_grads(f"{blabel} ({name})", got, again, ref, 1)
            require(bool((got[0][dead] == 0).all()),
                    f"{blabel}: a fully masked row got a non-zero input grad")
            ms = cuda_ms(lambda: tblock_backward(*a, g=g, heads=1), 10)
            pms = cuda_ms(lambda: tblock_backward_reference(*a, g=g, heads=1), 3)
            nbytes = 4 * (3 * r * t * c + 4 * r * c + 2 * sum(w.numel() for w in a[4:])) + r * t
            flops = tblock_bwd_flops(r, t, c, hid)
            results[blabel] = (err, ms, pms, *bound_ms(flops, nbytes, flops - 18 * r * t * c))
            new["tblock_bwd"].append(blabel)
            log(f"time {blabel}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                f"{results[blabel][3]:.3f} ms ({results[blabel][4]}) [{smi}]")
            del g, got, again, ref
        del x1, x2, mask, a, out
    torch.cuda.empty_cache()

    # one batch of 64 served with the block
    mcfg = cfg["model"]
    batch = synthetic_eval_batch(gen, 64, mcfg["max_seq_len"], mcfg["raw_input_dim_V"],
                                 mcfg["raw_input_dim_A"])
    eval_step = make_eval_step(model, cfg, device=dev)
    eval_step(batch)                                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dets = eval_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    served = counts()
    log(f"dependency serve: 1 batch x 64 videos, kernel launches {served}, peak memory "
        f"{peak:.2f} GiB [{smi}]")
    require(served["mhca"] == 5 + 12 and served["csp"] == 10 and served["nms"] == 1
            and served["conv3"] == 6 + 1,
            f"the dependency path did not run through its kernels: {served}")
    n = check_detections(dets, batch, mcfg["num_classes"])
    two = {k: v[:2] for k, v in batch.items()}
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        heads_gpu = model({k: v.to(dev) for k, v in two.items()}, with_losses=False)
        heads_cpu = cpu_model(two, with_losses=False)
    for key in ("cls_logits", "offsets"):
        a_ = torch.cat([x.flatten(1) for x in heads_gpu[key]], 1).cpu()
        b_ = torch.cat([x.flatten(1) for x in heads_cpu[key]], 1)
        rel = float((a_ - b_).norm() / b_.norm())
        log(f"check dependency gpu-vs-cpu {key} (the heads' outputs, 2 videos, every "
            f"level): norm-wise rel err {rel:.3e}")
        require(rel <= 1e-4, f"dependency gpu-vs-cpu: the heads' {key} differ")
    cpu_step = make_eval_step(cpu_model, cfg, device="cpu")
    compare_dets(dets, cpu_step(two), "dependency gpu-vs-cpu",
                 probe=lambda: [eval_step(pb) for pb in perturbed(two, gen)])
    set_stem("always")
    reset_counts()
    fdets = eval_step(batch)
    torch.cuda.synchronize()
    fl = counts()
    require(fused_tblock.launches == 4 + 12 and fl["mhca"] == 1 and fl["csp"] == 10,
            f"the dependency path with the whole-block stem: {fl}, "
            f"{fused_tblock.launches} TBlock launches")
    compare_dets(fdets, dets, "dependency whole-block-vs-default",
                 probe=lambda: [eval_step(pb) for pb in perturbed(batch, gen)])
    set_stem("never")
    log(f"dependency serve: {n} detections; with the whole-block stem "
        f"{fused_tblock.launches} TBlock launches (4 stem + 12 dependency)")

    # the block's share of a batch: its input captured, timed alone
    grabbed = {}
    hook = dep.register_forward_hook(lambda m, args, out: grabbed.update(args=args) and None)
    eval_step(batch)
    hook.remove()
    feats, masks = grabbed["args"][0], grabbed["args"][1]
    w_in, w_out = dep.feature_expand.conv.weight, dep.feature_squeeze.conv.weight
    cmasks = [m.contiguous() for m in masks]
    sq_in = [torch.randn(f.shape[0], f.shape[1], w_out.shape[1], generator=gen).to(dev)
             for f in feats]

    def block_convs():
        split = conv3_split(w_in)
        for f, m in zip(feats, cmasks):
            masked_conv3([f], w_in, [m], relu=True, split=split)
        masked_conv3(sq_in, w_out, cmasks, relu=False)

    with torch.inference_mode():
        dep_ms = cuda_ms(lambda: dep(feats, masks), 5)
        conv_ms = cuda_ms(block_convs, 5)
        cudnn_ms = cuda_ms(lambda: [dep.feature_squeeze(dep.feature_expand(f, m)[0], m)
                                    for f, m in zip(feats, masks)], 5)
    batch_ms = cuda_ms(lambda: eval_step(batch), 5)
    model.dependency = None
    base_ms = cuda_ms(lambda: eval_step(batch), 5)
    model.dependency = dep
    log(f"time dependency block in a batch of 64: {dep_ms:.3f} ms (the expand and squeeze "
        f"convs on the conv3 kernel: {conv_ms:.3f} ms, through MaskedConv1D and cuDNN fp32: "
        f"{cudnn_ms:.3f} ms); the whole batch {batch_ms:.3f} ms, {base_ms:.3f} ms without "
        f"the block [{smi}]")
    del feats, masks, cmasks, sq_in, grabbed, dets, fdets, eval_step, cpu_step, cpu_model
    torch.cuda.empty_cache()
    conv3_lines(model, dev, smi, gen, results)
    del model, dep
    torch.cuda.empty_cache()

    # two train steps at B=8
    tcfg = load_config(os.path.join(ROOT, "configs", "avel_unav100.yaml"))
    tcfg["model"]["use_dependency"] = True
    tm = tcfg["model"]
    b_, t_ = tcfg["loader"]["batch_size"], tm["max_seq_len"]
    tmodel = build_model(tcfg, device=dev, seed=seed)
    optimizer, _ = make_optimizer(tmodel, tcfg["opt"], 2, tcfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(tmodel, optimizer, tcfg["train_cfg"]["init_loss_norm"])
    step = make_train_step(tmodel, optimizer, tcfg, device=dev)
    tb = [synthetic_train_batch(gen, b_, t_, tm["raw_input_dim_V"], tm["raw_input_dim_A"],
                                tm["num_classes"], tcfg["dataset"]["max_num_events"])
          for _ in range(2)]
    before = [p.detach().clone() for p in tmodel.parameters()]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [step(state, tb[0], seed)]
    torch.cuda.synchronize()
    still = all(torch.equal(x, p) for x, p in zip(before, tmodel.parameters()))
    losses.append(step(state, tb[1], seed))
    torch.cuda.synchronize()
    trained = counts()
    tpeak = torch.cuda.max_memory_allocated() / 2**30
    log(f"dependency train: 2 steps at B={b_}, final_loss "
        f"{[float(x['final_loss']) for x in losses]}, launches {trained}, peak memory "
        f"{tpeak:.2f} GiB [{smi}]")
    require(still, "dependency train: step 1 (lr 0) changed a parameter")
    require(all(finite_losses(x) for x in losses), "dependency train: a non-finite loss")
    require(trained["mhca"] == trained["mhca_bwd"] == 2 * 17
            and trained["csp"] == trained["csp_bwd"] == 2 * 10,
            f"dependency train: not every kernel ran forward and backward: {trained}")
    step_ms = [host_ms(lambda: step(state, tb[0], seed)) for _ in range(3)]
    grabbed = {}
    hook = tmodel.dependency.register_forward_hook(
        lambda m, args, out: grabbed.update(args=args) and None)
    # a new step's first step runs eagerly: a replay runs no module's hook
    make_train_step(tmodel, optimizer, tcfg, device=dev)(state, tb[1], seed)
    hook.remove()
    feats = [f.detach().requires_grad_(True) for f in grabbed["args"][0]]
    masks = grabbed["args"][1]
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def dep_fwd_bwd():
        outs = tmodel.dependency(feats, masks, dgen)[0]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    dep_step_ms = cuda_ms(dep_fwd_bwd, 5)
    log(f"time dependency train step at B={b_}: {[round(x, 3) for x in step_ms]} ms a step "
        f"(host clock, synchronized); the block's forward + backward {dep_step_ms:.3f} ms "
        f"[{smi}]")
    log(f"dependency phase: {time.perf_counter() - t_phase:.1f} s")
    return {"served": served, "trained": trained, "new": new}


def bound_bf16_ms(flops: float, nbytes: float, tc_flops: float):
    """(bound ms, what bounds it) of a bf16 kernel: the `tc_flops` of its
    products at the dense bf16 peak, the rest at the fp32 FFMA peak, or its
    bytes at the memory rate where larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (tc_flops / PEAK_BF16_FLOPS + (flops - tc_flops) / PEAK_FP32_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def check_bf16(name, run, plain, plain32):
    """A bf16 kernel against its plain version on the same bf16 inputs:
    norm-wise <= BF16_TOL, each one's error against the fp32 plain version
    of the same inputs within 1.25x of the other's, the same bits on repeat.
    Returns (max abs err against the plain version, kernel output)."""
    import torch

    out, again, ref, ref32 = run(), run(), plain(), plain32()
    torch.cuda.synchronize()
    err, ek, ep = rel_err(out, ref), rel_err(out, ref32), rel_err(ref, ref32)
    same = torch.equal(out, again)
    max_abs = float((out.float() - ref.float()).abs().max())
    log(f"check {name}: norm-wise rel err vs plain bf16 {err:.3e} (max abs {max_abs:.3e}); vs "
        f"the fp32 plain version: kernel {ek:.3e}, plain {ep:.3e}; bit-identical on repeat: "
        f"{same}; finite: {bool(torch.isfinite(out).all())}")
    require(err <= BF16_TOL and ek <= 1.25 * ep and ep <= 1.25 * ek and same
            and bool(torch.isfinite(out).all()), f"{name}: off its bf16 gate")
    return max_abs, out


def bf16_bump(batch, gen, sign):
    """batch with one valid visual value per video moved by one bf16 ulp
    (up with sign +1, down with -1): the smallest change the bf16 program
    sees."""
    import torch

    v = batch["visual"].clone()
    lengths = batch["mask"].sum(1)
    for i in range(v.shape[0]):
        if lengths[i] == 0:
            continue
        j = int(torch.randint(int(lengths[i]), (1,), generator=gen))
        k = int(torch.randint(v.shape[-1], (1,), generator=gen))
        bits = v[i, j, k:k + 1].bfloat16().view(torch.int16)
        up = sign if float(v[i, j, k]) >= 0 else -sign
        v[i, j, k] = (bits + up).view(torch.bfloat16).float()[0]
    return dict(batch, visual=v)


def heads_gap(model, batch, dev):
    """(cls_logits, offsets) of model on batch, all levels flattened."""
    import torch

    with torch.inference_mode():
        out = model({"visual": batch["visual"].to(dev), "audio": batch["audio"].to(dev),
                     "mask": batch["mask"].bool().to(dev)}, with_losses=False)
    return [torch.cat([o.float().reshape(-1) for o in out[k]]).cpu()
            for k in ("cls_logits", "offsets")]


def bf16_attention_lines(dev, smi, gen) -> None:
    """The bf16 MHCA's attention alone (ops/fused_mhca.py:attention_forward)
    at the CSP's (128, 224, 256) and the stem's (64, 224, 512), 4 heads,
    with the eval protocol's ragged lengths and one empty sequence: held as
    the bf16 kernels are (check_bf16: its plain version, and the same steps
    in fp32), the empty sequence exact zeros; timed beside its plain version
    and, as a yardstick, PyTorch's scaled_dot_product_attention on the same
    values; its bound and resident blocks a SM."""
    import torch
    import torch.nn.functional as F

    from unav_yolyolva_tpu_torch.ops.fused_mhca import (attend, attention_blocks_per_sm,
                                                        attention_forward)
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    bf = torch.bfloat16
    for r, c, heads in ((128, 256, 4), (64, 512, 4)):
        t, d = 224, c // heads
        label = f"attn_bf16@{r}x{t}x{c}/{heads}h"
        q = (torch.randn(r, t, c, generator=gen) * d ** -0.5).to(dev, bf)
        k, v = (torch.randn(r, t, c, generator=gen).to(dev, bf) for _ in range(2))
        lengths = torch.randint(16, t + 1, (r,), generator=gen)
        lengths[-1] = 0
        mask = (torch.arange(t)[None, :] < lengths[:, None]).to(dev)
        _, out = check_bf16(label, lambda: attention_forward(q, k, v, mask, heads=heads),
                            lambda: attend(q, k, v, mask, heads),
                            lambda: attend(q.float(), k.float(), v.float(), mask, heads))
        require(bool((out[-1] == 0).all()), f"{label}: the empty sequence is not exact zeros")
        ms = cuda_ms(lambda: attention_forward(q, k, v, mask, heads=heads), 20)
        pms = cuda_ms(lambda: attend(q, k, v, mask, heads), 5)
        qh, kh, vh = (x.reshape(r, t, heads, d).transpose(1, 2).contiguous() for x in (q, k, v))
        amask = mask[:, None, None, :]
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask,
                                                             scale=1.0), 20)
        flops = 4 * r * heads * t * t * d
        bms, by = bound_bf16_ms(flops, 2 * 4 * r * t * c + r * t, flops)
        blocks = attention_blocks_per_sm(t, c, heads)
        log(f"time {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{pms:.3f} ms, library scaled_dot_product_attention {lms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), resident blocks a SM {blocks} [{smi}]")


def bf16_product_lines(dev, smi, gen) -> None:
    """The bf16 forward's products alone at the CSP layer's T=224, 2B=128
    shapes (A.B^T): the final conv (28672 x 512 x 1536), one of q/k/v
    (28672 x 256 x 256) and the three in one launch, the k=3 projection conv
    (28672 x 256 x 3 x 256, its taps read by the loader): the forward's
    product (bf16_products) beside the backward's strided product
    (bf16_layout_product, no conv loader) and cuBLAS's bf16 torch.matmul
    (fp32 sums) on the same values."""
    import torch

    from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_layout_product, bf16_products
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    bf, m = torch.bfloat16, 128 * 224
    for name, n, kc, taps, count in (("final", 512, 1536, 1, 1), ("qkv", 256, 256, 1, 1),
                                     ("qkv3", 256, 256, 1, 3), ("proj_conv", 256, 256, 3, 1)):
        x = torch.randn(m, kc, generator=gen).to(dev, bf)
        w = (torch.randn(n, taps * kc, generator=gen) / math.sqrt(taps * kc)).to(dev, bf)
        calls = [dict(x=x, w=w, taps=taps, seq=224)] * count
        ms = cuda_ms(lambda: bf16_products(calls), 20)
        flops = 2 * m * n * taps * kc * count
        line = (f"time product_bf16@{name} {count}x{m}x{n}x{taps * kc}: forward product "
                f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
        if taps == 1:
            xms = cuda_ms(lambda: [bf16_layout_product(x, w, "nt") for _ in range(count)], 20)
            lms = cuda_ms(lambda: [torch.matmul(x, w.T) for _ in range(count)], 20)
            line += (f", strided product {xms:.4f} ms ({flops / xms / 1e9:.1f} TFLOP/s, "
                     f"{count} launch{'es' if count > 1 else ''}), cuBLAS bf16 torch.matmul "
                     f"{lms:.4f} ms")
        bms, by = bound_bf16_ms(flops, 2 * count * (m * kc + n * taps * kc + m * n), flops)
        log(f"{line}, bound {bms:.4f} ms ({by}) [{smi}]")


def bf16_mlp_product_lines(dev, smi, gen) -> None:
    """The whole-block TBlock's two MLP products alone at the served stem's
    (64, 224, 512), hidden 2048, on their wgmma product
    (ops/gemm_tc.py:mlp_product): fc1 (14336 x 2048 x 512, bias + GELU) and
    fc2 (14336 x 512 x 2048, bias, row mask and out += y * mult_m), each held
    as `check gemm_bf16@...` holds the product (its fp32 sums' error against
    fp64 within 2x that of fp32 torch.matmul of the same bf16 values, its
    bf16 output within 1.25x cuBLAS bf16's, the same bits on repeat), then
    timed with its epilogue, and storing its fp32 sums alone (what the
    epilogue costs), beside the forward's mma.sync product (bf16_products,
    the same epilogue) and cuBLAS's bf16 torch.matmul (fp32 sums), which the
    port never calls."""
    import torch

    from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_products, mlp_product
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    bf, r, t, c, hid = torch.bfloat16, 64, 224, 512, 2048
    m = r * t
    rowmask = torch.rand(m, generator=gen).to(dev) > 0.1
    seqmul = (1 + 0.3 * torch.randn(r, c, generator=gen)).to(dev)
    resid = torch.randn(m, c, generator=gen).to(dev)
    out = torch.empty(m, c, device=dev)
    for name, n, k in (("fc1", hid, c), ("fc2", c, hid)):
        x = torch.randn(m, k, generator=gen).to(dev, bf)
        w = (torch.randn(n, k, generator=gen) / math.sqrt(k)).to(dev, bf)
        bias = (0.1 * torch.randn(n, generator=gen)).to(dev, bf)
        ref = x.double() @ w.double().T
        sums = mlp_product(x, w, epi="raw")
        y = mlp_product(x, w)
        err_sums, err_32 = rel_err(sums, ref), rel_err(torch.matmul(x.float(), w.float().T), ref)
        err_y, err_lib = rel_err(y, ref), rel_err(torch.matmul(x, w.T), ref)
        same = torch.equal(y, mlp_product(x, w))
        label = f"product_bf16@{name} {m}x{n}x{k}"
        log(f"check {label}: norm-wise err vs fp64 of its fp32 sums {err_sums:.3e} (fp32 "
            f"torch.matmul of the same bf16 values {err_32:.3e}), of its bf16 output "
            f"{err_y:.3e} (cuBLAS bf16 torch.matmul {err_lib:.3e}); bit-identical on repeat: "
            f"{same}")
        require(err_sums <= 2 * err_32 and err_y <= 1.25 * err_lib and same,
                f"{label}: off its gate")
        del ref, sums, y
        if name == "fc1":
            kw = dict(epi="gelu", bias=bias)
            old = dict(x=x, w=w, bias=bias, act="gelu")
        else:
            kw = dict(epi="res", bias=bias, rowmask=rowmask, seq=t, seqmul=seqmul, out=out)
            old = dict(kw, x=x, w=w, out=out)
            del old["epi"]

        def run(fn):
            if name == "fc2":
                out.copy_(resid)
            return fn()

        copy_ms = cuda_ms(lambda: out.copy_(resid), 20) if name == "fc2" else 0.0
        ms = cuda_ms(lambda: run(lambda: mlp_product(x, w, **kw)), 20) - copy_ms
        rms = cuda_ms(lambda: mlp_product(x, w, epi="raw"), 20)
        oms = cuda_ms(lambda: run(lambda: bf16_products([old])), 20) - copy_ms
        lms = cuda_ms(lambda: torch.matmul(x, w.T), 20)
        flops = 2 * m * n * k
        nbytes = 2 * (m * k + n * k + n) + (2 * m * n if name == "fc1" else 8 * m * n + m)
        bms, by = bound_bf16_ms(flops, nbytes, flops)
        log(f"time {label}: wgmma product with its epilogue {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s; storing its fp32 sums alone {rms:.4f} ms), the "
            f"forward's mma.sync product with the same "
            f"epilogue {oms:.4f} ms ({flops / oms / 1e9:.1f} TFLOP/s), cuBLAS bf16 "
            f"torch.matmul {lms:.4f} ms ({flops / lms / 1e9:.1f} TFLOP/s), bound {bms:.4f} ms "
            f"({by}) [{smi}]")


def bf16_forward_checks(model32, dev, smi, gen, results, profiled) -> None:
    """Phase 15's kernels: the three bf16 forward kernels against their
    plain versions at the protocol shapes, beside the fp32 kernels' times,
    each one's call added to profiled (launch_lines); the attention alone at the
    CSP's and the stem's shapes (`check/time attn_bf16@...`, its resident
    blocks a SM); the bf16 product alone against fp64 and cuBLAS, and at
    each of the forward's product shapes (`time product_bf16@...`)."""
    import torch

    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_reference, fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_reference
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_reference
    from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_products
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    bf = torch.bfloat16
    # ---- the three bf16 kernels at the protocol shapes ----------------------
    with torch.inference_mode():
        for label, key, r, c in (("mhca_bf16@64x224x512", "backbone.self_att_V.0.attn", 64, 512),
                                 ("mhca_bf16@128x224x256",
                                  "backbone.fusion_module.top_down_layers.4.blocks.0", 128, 256)):
            a = mhca_case(model32, key, r, 224, c, gen, dev)
            heads = dict(model32.named_modules())[key].n_head
            ab = (a[0].to(bf), a[1].to(bf), *a[2:])
            a32 = (ab[0].float(), ab[1].float(), *a[2:])
            err, _ = check_bf16(label, lambda: fused_mhca(*ab, heads=heads),
                                lambda: mhca_reference(*ab, heads=heads),
                                lambda: mhca_reference(*a32, heads=heads))
            ms = cuda_ms(lambda: fused_mhca(*ab, heads=heads), 10)
            pms = cuda_ms(lambda: mhca_reference(*ab, heads=heads), 5)
            fms = cuda_ms(lambda: fused_mhca(*a32, heads=heads), 10)
            nbytes = (2 * (r * 224 * c * 2) + 4 * (4 * c * c + 19 * c) + r * 224)
            results[label] = (err, ms, pms, *bound_bf16_ms(mhca_flops(r, 224, c), nbytes,
                                                           mhca_products(r, 224, c)), None)
            log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, the fp32 kernel on the "
                f"same inputs {fms:.3f} ms, bound {results[label][3]:.3f} ms "
                f"({results[label][4]}) [{smi}]")
            if r == 64:
                profiled.append((label, lambda ab=ab, h=heads: fused_mhca(*ab, heads=h)))

        for label, key, t in (("csp_bf16@T224/4h", "backbone.fusion_module.top_down_layers.4", 224),
                              ("csp_bf16@T224/8h", "backbone.fusion_module.bottom_up_layers.0", 224),
                              ("csp_bf16@T7/8h", "backbone.fusion_module.bottom_up_layers.4", 7)):
            a, heads = csp_case(model32, key, 128, t, gen, dev)
            ab = (a[0].to(bf), a[1].to(bf), *a[2:])
            a32 = (ab[0].float(), ab[1].float(), *a[2:])
            err, _ = check_bf16(label, lambda: fused_csp(*ab, attn_heads=heads),
                                lambda: csp_reference(*ab, attn_heads=heads),
                                lambda: csp_reference(*a32, attn_heads=heads))
            ms = cuda_ms(lambda: fused_csp(*ab, attn_heads=heads), 10)
            pms = cuda_ms(lambda: csp_reference(*ab, attn_heads=heads), 5)
            fms = cuda_ms(lambda: fused_csp(*a32, attn_heads=heads), 10)
            cin, fg = a[0].shape[-1], a[1].shape[-1]
            nbytes = (2 * (ab[0].numel() + ab[1].numel() + 128 * t * 512)
                      + 4 * sum(x.numel() for x in a[3:]) + 128 * t)
            flops = csp_flops(128, t, cin, 256, 512, fg, 512)
            # every FLOP but the MHCAs' conv + LayerNorm on the bf16 tensor
            # cores: the products and the gate's scores
            results[label] = (err, ms, pms, *bound_bf16_ms(
                flops, nbytes, flops - 3 * 18 * 128 * t * 256), None)
            log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, the fp32 kernel on the "
                f"same inputs {fms:.3f} ms, bound {results[label][3]:.3f} ms "
                f"({results[label][4]}; gate on the tensor cores) [{smi}]")
            if label != "csp_bf16@T224/8h":
                profiled.append((label,
                                 lambda ab=ab, h=heads: fused_csp(*ab, attn_heads=h)))

        label = "tblock_bf16@64x224x512"
        blk, a = tblock_case(model32, "backbone.self_att_V.0", 64, 224, gen, dev)
        heads, c, hid = blk.attn.n_head, a[0].shape[-1], a[11].shape[0]
        err, _ = check_bf16(label, lambda: fused_tblock(*a, heads=heads, cdtype=bf),
                            lambda: tblock_reference(*a, heads=heads, cdtype=bf),
                            lambda: tblock_reference(*a, heads=heads))
        ms = cuda_ms(lambda: fused_tblock(*a, heads=heads, cdtype=bf), 10)
        pms = cuda_ms(lambda: tblock_reference(*a, heads=heads, cdtype=bf), 5)
        fms = cuda_ms(lambda: fused_tblock(*a, heads=heads), 10)
        nbytes = 4 * (2 * 64 * 224 * c + 2 * 64 * c + sum(w.numel() for w in a[4:])) + 64 * 224
        results[label] = (err, ms, pms, *bound_bf16_ms(
            tblock_flops(64, 224, c, hid), nbytes,
            mhca_products(64, 224, c) + 4 * 64 * 224 * c * hid), None)
        log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, the fp32 kernel on the "
            f"same inputs {fms:.3f} ms, bound {results[label][3]:.3f} ms "
            f"({results[label][4]}) [{smi}]")
        profiled.append((label, lambda a=a, h=heads: fused_tblock(*a, heads=h, cdtype=bf)))

        # the bf16 product alone at the CSP final conv's shape, beside cuBLAS's
        # bf16 torch.matmul (fp32 sums: allow_bf16_reduced_precision_reduction
        # off), which the port never calls for its kernels' products
        m, n, k = 128 * 224, 512, 6 * 256
        xa = torch.randn(m, k, generator=gen).to(dev, bf)
        wa = (torch.randn(n, k, generator=gen) / math.sqrt(k)).to(dev, bf)
        ref = xa.double() @ wa.double().T
        sums = bf16_products([dict(x=xa, w=wa, raw=True)])[0]
        y = bf16_products([dict(x=xa, w=wa)])[0]
        err_sums = rel_err(sums, ref)
        err_32 = rel_err(torch.matmul(xa.float(), wa.float().T), ref)
        err_y, err_lib = rel_err(y, ref), rel_err(torch.matmul(xa, wa.T), ref)
        same = torch.equal(y, bf16_products([dict(x=xa, w=wa)])[0])
        log(f"check gemm_bf16@{m}x{n}x{k}: norm-wise err vs fp64 of its fp32 sums {err_sums:.3e} "
            f"(fp32 torch.matmul of the same bf16 values {err_32:.3e}), of its bf16 output "
            f"{err_y:.3e} (cuBLAS bf16 torch.matmul {err_lib:.3e}, allow_bf16_reduced_precision"
            f"_reduction={torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}); "
            f"bit-identical on repeat: {same}")
        require(err_sums <= 2 * err_32 and err_y <= 1.25 * err_lib and same,
                "the bf16 product is off its gate")
        del ref, sums
        ms = cuda_ms(lambda: bf16_products([dict(x=xa, w=wa)]), 20)
        lms = cuda_ms(lambda: torch.matmul(xa, wa.T), 20)
        flops = 2 * m * n * k
        bms, by = bound_bf16_ms(flops, 2 * (m * k + n * k + m * n), flops)
        log(f"time gemm_bf16@{m}x{n}x{k}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"library cuBLAS bf16 torch.matmul {lms:.4f} ms, bound {bms:.4f} ms ({by}) [{smi}]")
        del xa, wa, y
        bf16_attention_lines(dev, smi, gen)
        bf16_product_lines(dev, smi, gen)
        bf16_mlp_product_lines(dev, smi, gen)


def bf16_phase(model32, seed, dev, smi, gen, results, profiled) -> dict:
    """Phase 15: the bf16 compute policy on the serving path. The three bf16
    forward kernels against their plain versions at the protocol shapes,
    beside the fp32 kernels' times; the bf16 product alone against fp64 and
    cuBLAS; three batches of 64 served at bf16 with the default and the
    whole-block stem (the bf16 kernels launched, no fp32 kernel), the first
    two videos against the CPU's bf16 path; the eval CLI on
    configs/avel_unav100_bf16.yaml over 64 synthetic videos, bit-identical to
    the in-memory step; the bench at fp32 and bf16 in turns. Returns the bf16
    kernels' launches on the served path."""
    import contextlib
    import io
    import pickle
    import tempfile

    import numpy as np
    import torch
    import yaml

    from unav_yolyolva_tpu_torch.core import load_config
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                                        synthetic_eval_batch)
    from unav_yolyolva_tpu_torch.eval import cli, make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_csp import fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca
    from unav_yolyolva_tpu_torch.ops.fused_nms import multiclass_soft_nms
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock
    from unav_yolyolva_tpu_torch.tools import bench
    from unav_yolyolva_tpu_torch.train import valid_one_epoch

    t_phase = time.perf_counter()

    bf16_forward_checks(model32, dev, smi, gen, results, profiled)

    # ---- serve three batches of 64 at bf16 ---------------------------------
    cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100_eval.yaml"))
    cfg["tpu"]["compute_dtype"] = "bfloat16"
    mcfg = cfg["model"]
    model = build_model(cfg, device=dev, seed=seed)
    step = make_eval_step(model, cfg, device=dev)
    batches = [synthetic_eval_batch(gen, 64, mcfg["max_seq_len"], mcfg["raw_input_dim_V"],
                                    mcfg["raw_input_dim_A"]) for _ in range(3)]
    counted = (fused_mhca, fused_csp, fused_tblock)

    def reset():
        for fn in counted:
            fn.launches = fn.bf16_launches = 0
        multiclass_soft_nms.launches = 0

    def got():
        return {"mhca": fused_mhca.launches, "csp": fused_csp.launches,
                "tblock": fused_tblock.launches, "mhca_bf16": fused_mhca.bf16_launches,
                "csp_bf16": fused_csp.bf16_launches, "tblock_bf16": fused_tblock.bf16_launches,
                "nms": multiclass_soft_nms.launches}

    launches = {}
    served = {}
    for stem in ("never", "always"):
        set_stem(stem)
        reset()
        served[stem] = [step(b) for b in batches]
        torch.cuda.synchronize()
        n = got()
        log(f"serve bf16 ({'whole-block' if stem == 'always' else 'default'} stem): 3 batches "
            f"x 64 videos, kernel launches {n}")
        want = ({"tblock_bf16": 12, "mhca_bf16": 3} if stem == "always"
                else {"tblock_bf16": 0, "mhca_bf16": 15})
        require(n["mhca"] == n["csp"] == n["tblock"] == 0 and n["csp_bf16"] == 30
                and n["nms"] == 3 and all(n[k] == v for k, v in want.items()),
                f"the bf16 path did not run through its kernels alone: {n}")
        launches.update({k: n[k] for k in (("tblock_bf16",) if stem == "always"
                                           else ("mhca_bf16", "csp_bf16"))})
        for d, b in zip(served[stem], batches):
            check_detections(d, b, mcfg["num_classes"])
    set_stem("never")

    # the first two videos against the CPU's bf16 path: the heads' outputs by
    # the CPU tests' criterion (tests/test_torch_port_bf16.py: at most 1/4 of
    # the bf16-vs-fp32 gap, or 2x the model's own move under one input value
    # moved by one bf16 ulp, and at most 2e-2), the detections as the fp32
    # phases compare them, near-ties (here: videos that move under a one-ulp
    # change of one input value) allowed
    two = {k: v[:2] for k, v in batches[0].items()}
    cpu_model = copy.deepcopy(model).cpu()
    cpu32 = copy.deepcopy(model32).cpu()
    gpu_h = heads_gap(model, two, dev)
    cpu_h = heads_gap(cpu_model, two, "cpu")
    cpu32_h = heads_gap(cpu32, two, "cpu")
    bumps = [heads_gap(model, bf16_bump(two, gen, s), dev) for s in (1, -1)]
    for i, name in enumerate(("cls_logits", "offsets")):
        gap, ref_gap = rel_err(gpu_h[i], cpu_h[i]), rel_err(cpu_h[i], cpu32_h[i])
        sens = float(np.mean([rel_err(bp[i], gpu_h[i]) for bp in bumps]))
        log(f"check bf16 gpu-vs-cpu {name} (B=2): norm-wise {gap:.3e}; CPU bf16 vs fp32 "
            f"{ref_gap:.3e}; the card's bf16 heads moved by one input value one bf16 ulp "
            f"{sens:.3e}")
        require(gap <= 2e-2 and gap <= max(0.25 * ref_gap, 2 * sens),
                f"bf16 {name}: the card and the CPU differ by {gap:.3e}")
    cpu_step = make_eval_step(cpu_model, cfg, device="cpu")
    ulp = "one input value of each video moved by one bf16 ulp"
    compare_dets(served["never"][0], cpu_step(two), "bf16 gpu-vs-cpu",
                 probe=lambda: [step(bf16_bump(two, gen, s)) for s in (1, -1)], moved_by=ulp)
    set_stem("always")
    for fd, d, b in zip(served["always"], served["never"], batches):
        compare_dets(fd, d, "bf16 whole-block-vs-default",
                     probe=lambda: [step(bf16_bump(b, gen, s)) for s in (1, -1)], moved_by=ulp)
    set_stem("never")
    del cpu_model, cpu32, cpu_step

    # ---- the eval CLI on configs/avel_unav100_bf16.yaml ----------------------
    with tempfile.TemporaryDirectory() as root:
        synth = make_synthetic_dataset(root, num_videos=64, num_classes=100, min_len=48,
                                       max_len=224, visual_dim=2048, audio_dim=128,
                                       val_fraction=1.0, seed=seed)
        with open(os.path.join(ROOT, "configs", "avel_unav100_bf16.yaml")) as f:
            raw = yaml.safe_load(f)
        raw["test_split"] = ["validation"]
        raw["dataset"].update(json_file=synth["json_file"], feat_folder=synth["feat_folder"])
        cfg_yaml = os.path.join(root, "bf16.yaml")
        with open(cfg_yaml, "w") as f:
            yaml.safe_dump(raw, f)
        ccfg = load_config(cfg_yaml)
        ckpt = os.path.join(root, "model_best.pth.tar")
        reference_checkpoint(build_model(ccfg, device=dev, seed=seed), ckpt)
        reset()
        mAP = cli.main(cli.parse_args([cfg_yaml, ckpt, "--print-freq", "1000"]))
        torch.cuda.synchronize()
        n = got()
        log(f"serve bf16 from files (eval CLI, configs/avel_unav100_bf16.yaml, 64 videos, "
            f"batch {ccfg['loader']['batch_size']}): average mAP {mAP!r}, kernel launches {n}")
        require(math.isfinite(mAP) and 0.0 <= mAP <= 1.0 and n["mhca"] == n["csp"] == 0
                and n["mhca_bf16"] > 0 and n["csp_bf16"] > 0 and n["nms"] > 0,
                f"the bf16 CLI did not serve through the bf16 kernels: {n}, mAP {mAP}")
        cli.main(cli.parse_args([cfg_yaml, ckpt, "--saveonly", "--print-freq", "1000"]))
        with open(os.path.join(root, "eval_results.pkl"), "rb") as f:
            piped = pickle.load(f)
        ds = UnAV100Dataset(False, ccfg["test_split"], **ccfg["dataset"])
        cmodel = build_model(ccfg, device=dev, seed=seed)
        with make_batcher(ds, ccfg, False, device="cpu") as batcher:
            plain = list(batcher)
        ref_file = os.path.join(root, "in_memory.pkl")
        valid_one_epoch(cmodel, plain, make_eval_step(cmodel, ccfg, device=dev), -1,
                        output_file=ref_file, print_freq=1000)
        with open(ref_file, "rb") as f:
            ref = pickle.load(f)
        same = list(piped["video-id"]) == list(ref["video-id"]) and all(
            piped[k].dtype == ref[k].dtype and np.array_equal(piped[k], ref[k])
            for k in ("t-start", "t-end", "label", "score"))
        log(f"check bf16 serve-from-files detections: {len(ref['video-id'])} detections of 64 "
            f"videos, the CLI's bit-identical to in-memory make_eval_step's: {same}")
        require(same, "the bf16 CLI's detections differ from the in-memory step's")
        del cmodel

    # ---- the bench at fp32 and bf16, in turns ------------------------------------
    del model, step
    torch.cuda.empty_cache()
    rates = {"float32": [], "bfloat16": []}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(["--no-train", "--compute-dtype", dtype, "--commit", "unknown",
                        "--seed", str(seed)])
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        rates[dtype].append(rec)
        log(f"time bench eval {dtype}: {rec['value']:.1f} videos/s (median of "
            f"{len(rec['windows'])} windows of {rec['iters']} steps, spread "
            f"{rec['spread_pct']:.1f}%), busy share {rec['busy_share']:.3f}, peak memory "
            f"{rec['peak_memory_gib']:.2f} GiB [{smi}]")
    log(f"bf16 phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def check_bf16_grads(name, run, plain, plain32, n_inputs, moved, plain_cpu=None):
    """A bf16 backward kernel against its plain version on the same inputs:
    every grad tensor finite, of the plain version's dtype, the same bits on
    repeat, and norm-wise within 1/4 of the plain version's own gap to the
    fp32 plain version (exactly 0 where that is 0). The kernel's and the
    plain version's fp32 sums, taken in other orders, round a few bf16
    values apart, and each such flip spreads through every later bf16 op
    (the CSP layer's three MHCAs, the TBlock's MHCA and MLP). A grad beyond
    1/4 of the gap is held instead within 2x the kernel's own move when one
    input value of each row moves by one bf16 ulp (`moved(sign)` runs the
    kernel so, the larger of up and down): PR 10's fallback for the whole
    model, taken per kernel. With `plain_cpu` (the plain version on the
    CPU) each grad's line also gives the order floor: how far the same plain
    bf16 program, summed in the CPU's orders, sits from the plain version on
    the card. Returns the max abs error of the input grads against the plain
    version."""
    import torch

    got, again, ref, ref32 = run(), run(), plain(), plain32()
    ups, downs = moved(1), moved(-1)
    torch.cuda.synchronize()
    order = [rel_err(c, p.cpu()) for c, p in zip(plain_cpu(), ref)] if plain_cpu else None
    worst, lines, bad, loose = 0.0, [], [], []
    for i, (k, p, p32) in enumerate(zip(got, ref, ref32)):
        err, gap = rel_err(k, p), rel_err(p, p32)
        move = max(rel_err(ups[i], k), rel_err(downs[i], k))
        worst = max(worst, err / gap if gap else (0.0 if err == 0 else math.inf))
        lines.append(f"{i}:{err:.2e}/{gap:.2e}/{move:.2e}"
                     + (f"/{order[i]:.2e}" if order else ""))
        ok = k.dtype == p.dtype and bool(torch.isfinite(k).all())
        if not (err <= 0.25 * gap if gap else bool((k == p).all())):
            loose.append(i)
            ok = ok and err <= 2 * move
        if not ok:
            bad.append(i)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    max_abs = max(float((got[i].float() - ref[i].float()).abs().max()) for i in range(n_inputs))
    floor = " / the plain version on the CPU vs on the card" if order else ""
    log(f"check {name}: per grad, norm-wise err vs plain bf16 / plain bf16-vs-fp32 gap / "
        f"the kernel's one-ulp move{floor} {' '.join(lines)}; worst err/gap {worst:.3f}; "
        f"beyond 1/4 of the gap (held within 2x the one-ulp move instead): {loose}; input "
        f"grads max abs {max_abs:.3e}; bit-identical on repeat: {same}")
    require(not bad, f"{name}: grads {bad} off their bf16 gate")
    require(same, f"{name}: two runs of the bf16 backward kernel differ")
    return max_abs


def check_row_blocks(name, module, picker, rows, kernel, plain_cpu, first_weight, n_inputs):
    """The kernel follows the JAX row blocks. With the port's copy of the
    JAX row picker (`module.picker`) set to `rows` instead of its own R:
    the kernel's input grads do not move (its per-row program does not
    depend on R); each weight grad that the plain version on the CPU moves
    (the JAX program rounds it per block) the kernel moves by as much
    (within 2x either way: as many roundings), and, where the two programs
    agree bit for bit on the input grads (no rounding flip between them, so
    the blocks' sums are the same values), by the same amounts: the
    kernel's move minus the plain version's within 1/4 of the plain
    version's; each grad the plain version leaves in place (fp32 sums, such
    as the LayerNorms' affine grads) the kernel moves by the fp32 sums'
    order at most (1e-5 norm-wise). The plain version runs on the CPU,
    whose values do not depend on R (the card's picks cuBLAS algorithms by
    the block's rows). A kernel that rounded its weight grads once, or
    summed a bias in fp32, would not move."""
    import torch

    base_k, base_p = kernel(), plain_cpu()
    own = getattr(module, picker)
    setattr(module, picker, lambda *a, **k: rows)
    try:
        k1, p1 = kernel(), plain_cpu()
    finally:
        setattr(module, picker, own)
    still = all(torch.equal(k1[i], base_k[i]) for i in range(n_inputs))
    exact = all(torch.equal(base_k[i].cpu(), base_p[i]) for i in range(n_inputs))
    lines, bad, moved = [], [], 0
    for i in range(first_weight, len(p1)):
        norm = float(p1[i].double().norm()) or 1.0
        dp = p1[i].double() - base_p[i].double()
        dk = (k1[i].double() - base_k[i].double()).cpu()
        shift, kmove = float(dp.norm()) / norm, float(dk.norm()) / norm
        off = float((dk - dp).norm()) / norm
        lines.append(f"{i}:{kmove:.2e}/{shift:.2e}/{off:.2e}")
        if shift > 1e-5:
            moved += 1
            ok = 0.5 * shift <= kmove <= 2 * shift and (off <= 0.25 * shift or not exact)
        else:
            ok = kmove <= 1e-5
        if not ok:
            bad.append(i)
    log(f"check {name} row blocks: with {picker} at {rows}, per weight grad (norm-wise) the "
        f"kernel's move / the CPU plain version's / their difference {' '.join(lines)}; input "
        f"grads unmoved: {still}; equal to the plain version's (moves compared value by "
        f"value): {exact}")
    require(still and moved >= 4 and not bad,
            f"{name}: the kernel does not follow the row blocks ({moved} moved, off {bad})")


def bf16_backward_checks(model32, dev, smi, gen, results, B, T):
    """Phase 16, part 1: the three bf16 backward kernels against their plain
    versions, small and at the train protocol's shapes (check_bf16_grads);
    the small CSP and TBlock cases again with the row picker at 1
    (check_row_blocks); at the protocol each kernel timed beside the fp32
    backward kernel on the same inputs; then the backward's bf16 product
    alone in its A.B and A^T.B layouts at the CSP backward's final conv."""
    import torch

    from unav_yolyolva_tpu_torch.ops import fused_csp, fused_tblock
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, csp_backward_reference
    from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward, mhca_backward_reference
    from unav_yolyolva_tpu_torch.ops.fused_tblock import (tblock_backward,
                                                          tblock_backward_reference)
    from unav_yolyolva_tpu_torch.tools.grad_gaps import gate_margins, ulp_bump
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    bf = torch.bfloat16

    def bump(x, mask, sign):
        return ulp_bump(x, mask, gen, sign)

    # small cases, short sums: most grads take the plain versions' roundings
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def mhca_ws(c):
        return [rnd(3, c, 3, scale=0.5), 1 + rnd(3, c, scale=0.1), rnd(3, c, scale=0.1),
                rnd(4, c, c, scale=c ** -0.5), rnd(4, c, scale=0.1)]

    r, t, c = 3, 16, 64
    mask = torch.arange(t, device=dev)[None, :] < torch.tensor([t, 9, 0], device=dev)[:, None]
    x1, x2, g = rnd(r, t, c).to(bf), rnd(r, t, c).to(bf), rnd(r, t, c).to(bf)
    ws = mhca_ws(c)
    check_bf16_grads("mhca_bwd_bf16@3x16x64", lambda: mhca_backward(x1, x2, mask, *ws, g, heads=4),
                     lambda: mhca_backward_reference(x1, x2, mask, *ws, g, heads=4),
                     lambda: mhca_backward_reference(x1.float(), x2.float(), mask, *ws,
                                                     g.float(), heads=4), 2,
                     lambda s: mhca_backward(bump(x1, mask, s), x2, mask, *ws, g, heads=4))
    for t, heads in ((16, 4), (7, 8)):
        mid, cin, ng, fg = 32, 64, 16, 24
        packs = [mhca_ws(mid) for _ in range(3)]
        a = [rnd(r, t, cin).to(bf), rnd(r, ng, fg).to(bf),
             torch.arange(t, device=dev)[None, :] < torch.tensor([t, 3, t - 1],
                                                                 device=dev)[:, None],
             rnd(2 * mid, cin, scale=cin ** -0.5), rnd(2 * mid, scale=0.1),
             *[torch.stack([p[i] for p in packs]) for i in range(5)],
             rnd(mid, fg, scale=fg ** -0.5), rnd(mid, scale=0.1), rnd(heads),
             rnd(mid, mid, 3, scale=(3 * mid) ** -0.5), rnd(mid, scale=0.1),
             rnd(cin, 6 * mid, scale=(6 * mid) ** -0.5), rnd(cin, scale=0.1)]
        gc = rnd(r, t, cin).to(bf)
        a32 = [a[0].float(), a[1].float(), *a[2:]]
        name = f"csp_bwd_bf16@T{t}/{heads}h small"
        check_bf16_grads(name, lambda: csp_backward(*a, g=gc, attn_heads=heads),
                         lambda: csp_backward_reference(*a, g=gc, attn_heads=heads),
                         lambda: csp_backward_reference(*a32, g=gc.float(), attn_heads=heads),
                         2, lambda s: csp_backward(bump(a[0], a[2], s), *a[1:], g=gc,
                                                   attn_heads=heads))
        check_row_blocks(name, fused_csp, "pick_rows_csp_bwd", 1,
                         lambda: csp_backward(*a, g=gc, attn_heads=heads),
                         lambda: csp_backward_reference(*[v.cpu() for v in a], g=gc.cpu(),
                                                        attn_heads=heads), 2, 2)
    t, hid = 16, 4 * c
    a = [rnd(r, t, c), mask, 0.7 + rnd(r, 1, c, scale=0.3), 1.3 + rnd(r, 1, c, scale=0.3),
         1 + rnd(3, c, scale=0.1), rnd(3, c, scale=0.1), *mhca_ws(c),
         rnd(hid, c, scale=c ** -0.5), rnd(hid, scale=0.1), rnd(c, hid, scale=hid ** -0.5),
         rnd(c, scale=0.1)]
    gt = rnd(r, t, c)
    check_bf16_grads("tblock_bwd_bf16@3x16x64",
                     lambda: tblock_backward(*a, g=gt, heads=4, cdtype=bf),
                     lambda: tblock_backward_reference(*a, g=gt, heads=4, cdtype=bf),
                     lambda: tblock_backward_reference(*a, g=gt, heads=4), 1,
                     lambda s: tblock_backward(bump(a[0], mask, s), *a[1:], g=gt, heads=4,
                                               cdtype=bf))
    check_row_blocks("tblock_bwd_bf16@3x16x64", fused_tblock, "pick_rows_tb_bwd", 1,
                     lambda: tblock_backward(*a, g=gt, heads=4, cdtype=bf),
                     lambda: tblock_backward_reference(*[v.cpu() for v in a], g=gt.cpu(),
                                                       heads=4, cdtype=bf), 3, 1)

    for label, key, r, c in ((f"mhca_bwd_bf16@{B}x{T}x512", "backbone.self_att_V.0.attn", B, 512),
                             (f"mhca_bwd_bf16@{2 * B}x{T}x256",
                              "backbone.fusion_module.top_down_layers.4.blocks.0", 2 * B, 256)):
        a = mhca_case(model32, key, r, T, c, gen, dev)
        heads = dict(model32.named_modules())[key].n_head
        ab = (a[0].to(bf), a[1].to(bf), *a[2:])
        a32 = (ab[0].float(), ab[1].float(), *a[2:])
        g = torch.randn(r, T, c, generator=gen).to(dev, bf)

        def moved(sign, selfattn=a[1] is a[0]):
            xb = bump(ab[0], ab[2], sign)
            return mhca_backward(xb, xb if selfattn else ab[1], *ab[2:], g, heads=heads)

        err = check_bf16_grads(label, lambda: mhca_backward(*ab, g, heads=heads),
                               lambda: mhca_backward_reference(*ab, g, heads=heads),
                               lambda: mhca_backward_reference(*a32, g.float(), heads=heads), 2,
                               moved)
        ms = cuda_ms(lambda: mhca_backward(*ab, g, heads=heads), 10)
        fms = cuda_ms(lambda: mhca_backward(*a32, g.float(), heads=heads), 10)
        pms = cuda_ms(lambda: mhca_backward_reference(*ab, g, heads=heads), 3)
        flops = mhca_bwd_flops(r, T, c)
        nbytes = 2 * 5 * r * T * c + 4 * 2 * (4 * c * c + 19 * c) + r * T
        results[label] = (err, ms, pms, *bound_bf16_ms(flops, nbytes, flops - 18 * r * T * c),
                          fms)
        log(f"time {label}: kernel {ms:.3f} ms, the fp32 backward kernel on the same inputs "
            f"{fms:.3f} ms, plain {pms:.3f} ms, bound {results[label][3]:.3f} ms "
            f"({results[label][4]}) [{smi}]")
    for label, key, t in ((f"csp_bwd_bf16@T{T}/4h", "backbone.fusion_module.top_down_layers.4", T),
                          (f"csp_bwd_bf16@T{T}/8h", "backbone.fusion_module.bottom_up_layers.0",
                           T),
                          ("csp_bwd_bf16@T7/8h", "backbone.fusion_module.bottom_up_layers.4", 7),
                          ("csp_bwd_bf16@T7/4h", "backbone.fusion_module.top_down_layers.4", 7)):
        a, heads = csp_case(model32, key, 2 * B, t, gen, dev)
        ab = (a[0].to(bf), a[1].to(bf), *a[2:])
        a32 = (ab[0].float(), ab[1].float(), *a[2:])
        g = torch.randn(2 * B, t, 512, generator=gen).to(dev, bf)
        margins = []

        def plain():
            with gate_margins(margins):
                return csp_backward_reference(*ab, g=g, attn_heads=heads)

        err = check_bf16_grads(label, lambda: csp_backward(*ab, g=g, attn_heads=heads), plain,
                               lambda: csp_backward_reference(*a32, g=g.float(),
                                                              attn_heads=heads), 2,
                               lambda s: csp_backward(bump(ab[0], ab[2], s), *ab[1:], g=g,
                                                      attn_heads=heads),
                               lambda: csp_backward_reference(*[v.cpu() for v in ab],
                                                              g=g.cpu(), attn_heads=heads))
        low, ties, n = min(m[1] for m in margins), sum(m[2] for m in margins), margins[0][3]
        log(f"gates {label}: the plain version's smallest top-2 margin of the gate's max "
            f"{low:.3e}, valid positions under 1e-5: {ties} of {n * len(margins)}")
        ms = cuda_ms(lambda: csp_backward(*ab, g=g, attn_heads=heads), 10)
        fms = cuda_ms(lambda: csp_backward(*a32, g=g.float(), attn_heads=heads), 10)
        pms = cuda_ms(lambda: csp_backward_reference(*ab, g=g, attn_heads=heads), 1, warmup=1)
        cin, fg = a[0].shape[-1], a[1].shape[-1]
        nbytes = (2 * 2 * (ab[0].numel() + ab[1].numel()) + 2 * g.numel()
                  + 4 * 2 * sum(x.numel() for x in a[3:]) + a[2].numel())
        # every product on the bf16 tensor cores; the gate's scores (forward
        # and their grads) and the MHCAs' conv + LN on FFMA
        flops = csp_bwd_flops(2 * B, t, cin, 256, 512, fg, 512)
        results[label] = (err, ms, pms, *bound_bf16_ms(
            flops, nbytes, flops - 3 * 2 * 2 * B * t * 256 * 512 - 3 * 18 * 2 * B * t * 256),
            fms)
        log(f"time {label}: kernel {ms:.3f} ms, the fp32 backward kernel on the same inputs "
            f"{fms:.3f} ms, plain {pms:.3f} ms, bound {results[label][3]:.3f} ms "
            f"({results[label][4]}) [{smi}]")
    label = f"tblock_bwd_bf16@{B}x{T}x512"
    blk, a = tblock_case(model32, "backbone.self_att_V.0", B, T, gen, dev)
    heads, c, hid = blk.attn.n_head, a[0].shape[-1], a[11].shape[0]
    g = torch.randn(B, T, c, generator=gen).to(dev)
    err = check_bf16_grads(label, lambda: tblock_backward(*a, g=g, heads=heads, cdtype=bf),
                           lambda: tblock_backward_reference(*a, g=g, heads=heads, cdtype=bf),
                           lambda: tblock_backward_reference(*a, g=g, heads=heads), 1,
                           lambda s: tblock_backward(bump(a[0], a[1], s), *a[1:], g=g,
                                                     heads=heads, cdtype=bf),
                           lambda: tblock_backward_reference(*[v.cpu() for v in a], g=g.cpu(),
                                                             heads=heads, cdtype=bf))
    ms = cuda_ms(lambda: tblock_backward(*a, g=g, heads=heads, cdtype=bf), 10)
    fms = cuda_ms(lambda: tblock_backward(*a, g=g, heads=heads), 10)
    pms = cuda_ms(lambda: tblock_backward_reference(*a, g=g, heads=heads, cdtype=bf), 2)
    nbytes = 4 * (3 * B * T * c + 4 * B * c + 2 * sum(w.numel() for w in a[4:])) + B * T
    flops = tblock_bwd_flops(B, T, c, hid)
    results[label] = (err, ms, pms, *bound_bf16_ms(flops, nbytes, flops - 18 * B * T * c), fms)
    log(f"time {label}: kernel {ms:.3f} ms, the fp32 backward kernel on the same inputs "
        f"{fms:.3f} ms, plain {pms:.3f} ms, bound {results[label][3]:.3f} ms "
        f"({results[label][4]}) [{smi}]")
    bf16_layout_checks(dev, smi, gen, B, T)


def bf16_layout_checks(dev, smi, gen, B, T):
    """The backward's bf16 product alone (ops/gemm_tc.py:bf16_layout_product)
    at the CSP backward's final conv (T=224, 2B=16 of the train protocol):
    dcat = g Wfinal (A.B) and Wfinal's grad g^T cat (A^T.B), summed in JAX
    row blocks of T rows (R=1), each block rounded to bf16. Their fp32 sums'
    error against fp64 within 2x that of fp32 torch.matmul of the same bf16
    values; the rounded weight grad within a flip of its plain version on at
    most 1% of the values; the same bits on repeat; each timed beside
    cuBLAS's bf16 torch.matmul (fp32 sums, rounded once)."""
    import torch

    from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_layout_product, bf16_layout_reference
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms

    bf = torch.bfloat16
    pb, cout, c6 = 2 * B * T, 512, 6 * 256
    gb = torch.randn(pb, cout, generator=gen).to(dev, bf)
    wf = (torch.randn(cout, c6, generator=gen) / math.sqrt(cout)).to(dev, bf)
    cat = torch.randn(pb, c6, generator=gen).to(dev, bf)
    for label, a, b, layout, kw, lib in (
            (f"gemm_bf16_nn@{pb}x{c6}x{cout}", gb, wf, "nn", {}, lambda: torch.matmul(gb, wf)),
            (f"gemm_bf16_wgrad@{cout}x{c6}x{pb}", gb, cat, "tn", dict(kblock=T),
             lambda: torch.matmul(gb.T, cat))):
        sums = bf16_layout_product(a, b, layout, out_bf16=False, **kw)
        exact = (a.double().T if layout == "tn" else a.double()) @ b.double()
        err, err_32 = rel_err(sums, exact), rel_err(torch.matmul(
            a.float().T if layout == "tn" else a.float(), b.float()), exact)
        ok = err <= 2 * err_32
        what = f"fp32 sums' norm-wise err vs fp64 {err:.3e} (fp32 torch.matmul {err_32:.3e})"
        if layout == "tn":
            kw = dict(kw, round_blocks=True)
            y = bf16_layout_product(a, b, layout, out_bf16=False, **kw)
            flips = float((y != bf16_layout_reference(a, b, layout, out_bf16=False,
                                                      **kw)).float().mean())
            ok = ok and flips <= 0.01
            what += f"; blocks of {T} rows rounded: share of values a flip apart {flips:.2e}"
        same = torch.equal(bf16_layout_product(a, b, layout, **kw),
                           bf16_layout_product(a, b, layout, **kw))
        log(f"check {label}: {what}; bit-identical on repeat: {same}")
        require(ok and same, f"{label}: off its gate")
        ms = cuda_ms(lambda: bf16_layout_product(a, b, layout, **kw), 20)
        lms = cuda_ms(lib, 20)
        flops = 2 * pb * cout * c6
        bms, by = bound_bf16_ms(flops, 2 * (pb * cout + cout * c6 + pb * c6), flops)
        log(f"time {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), library "
            f"cuBLAS bf16 torch.matmul {lms:.4f} ms, bound {bms:.4f} ms ({by}) [{smi}]")
        del sums, exact


def bf16_train_phase(seed, dev, smi, gen, results, B, T) -> dict:
    """Phase 16: the bf16 train step (configs/avel_unav100_bf16.yaml, B=8,
    T=224, AdamW, warmup + cosine, droppath 0.1, EMA; fp32 parameters,
    AdamW state, EMA and losses). The three bf16 backward kernels against
    their plain versions (bf16_backward_checks); three train steps with the
    default and the whole-block stem, each bf16 backward kernel launched as
    often as its forward and no fp32 MHCA, CSP or TBlock kernel; one step's
    grads at B=2 on the card against the CPU's bf16 plain path; the train
    CLI on the bf16 config from files, 3 epochs of 4 steps with validation,
    then a resume that repeats the straight run's last epoch bit for bit; the
    bench's train half at fp32 and bf16 in turns. Returns the bf16 backward
    kernels' launches (per 3 steps, and in the CLI's run)."""
    import contextlib
    import io
    import tempfile

    import torch
    import yaml

    from unav_yolyolva_tpu_torch.core import load_config
    from unav_yolyolva_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                                        synthetic_train_batch)
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_backward
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_backward
    from unav_yolyolva_tpu_torch.tools import bench
    from unav_yolyolva_tpu_torch.tools.grad_gaps import step_grads
    from unav_yolyolva_tpu_torch.train import (cli, create_train_state, make_optimizer,
                                               make_train_step)

    t_phase = time.perf_counter()
    fns = {"mhca": fused_mhca, "csp": fused_csp, "tblock": fused_tblock,
           "mhca_bwd": mhca_backward, "csp_bwd": csp_backward, "tblock_bwd": tblock_backward}

    def reset():
        for f in fns.values():
            f.launches = f.bf16_launches = 0

    def got():
        out = {k: f.launches for k, f in fns.items()}
        out.update({f"{k}_bf16": f.bf16_launches for k, f in fns.items()})
        return out

    def through_bf16(n, steps, per_step, what):
        """The bf16 backward kernels ran as often as their forwards in
        training (per_step a step), and no fp32 kernel ran."""
        fp32 = {k: v for k, v in n.items() if not k.endswith("_bf16") and v}
        want = {f"{k}_bwd_bf16": steps * v for k, v in per_step.items()}
        require(not fp32 and all(n[k] == v for k, v in want.items())
                and all(n[f"{k}_bf16"] >= steps * v for k, v in per_step.items()),
                f"{what}: the bf16 train path's launches {n}, expected backward {want} and "
                f"no fp32 kernel")

    tcfg = load_config(os.path.join(ROOT, "configs", "avel_unav100.yaml"))
    tmodel = build_model(tcfg, device=dev, seed=seed)
    bf16_backward_checks(tmodel, dev, smi, gen, results, B, T)
    del tmodel
    # torch.profiler can come back without device events once a process has
    # traced a while (phase 15's bench, phases 4b and 13; in one full run the
    # CSP backward's profile at T=224 did so even after a warm-up profile):
    # the launch budget is measured in a process of its own, which builds
    # only the train model
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--bf16-profile-only",
                           "--seed", str(seed)], capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith(("launches ", "attention ", "host ")):
            log(line)
    require(proc.returncode == 0, "phase 16's profile of the bf16 backward kernels failed:\n"
            + "\n".join((proc.stdout + proc.stderr).splitlines()[-20:]))

    # ---- the train step at bf16, both stems ------------------------------------
    cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100_bf16.yaml"))
    m = cfg["model"]
    require(cfg["tpu"]["compute_dtype"] == "bfloat16" and cfg["loader"]["batch_size"] == B
            and m["max_seq_len"] == T, "configs/avel_unav100_bf16.yaml is not the protocol")
    batches = [synthetic_train_batch(gen, B, T, m["raw_input_dim_V"], m["raw_input_dim_A"],
                                     m["num_classes"], cfg["dataset"]["max_num_events"])
               for _ in range(3)]
    launches = {}
    for stem, per_step in (("never", {"mhca": 5, "csp": 10}),
                           ("always", {"mhca": 1, "csp": 10, "tblock": 4})):
        set_stem(stem)
        model = build_model(cfg, device=dev, seed=seed)
        opt, _ = make_optimizer(model, cfg["opt"], 100, cfg["train_cfg"]["clip_grad_l2norm"])
        state = create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])
        step = make_train_step(model, opt, cfg, device=dev)
        step(state, batches[0], seed)                                   # warm-up
        torch.cuda.synchronize()
        reset()
        before = ran(step)
        t0 = time.perf_counter()
        losses = [step(state, bt, seed) for bt in batches]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n, counted = got(), ran(step) - before
        launches[stem] = n
        log(f"train bf16 ({'whole-block' if stem == 'always' else 'default'} stem): 3 steps "
            f"at B={B} in {secs:.2f} s ({counted} captured, {step.replays} replays), final "
            f"losses {[round(float(x['final_loss']), 5) for x in losses]}, kernel launches {n}")
        require(all(finite_losses(x) for x in losses)
                and all(x["final_loss"].dtype == torch.float32 for x in losses)
                and all(p.dtype == torch.float32 for p in model.parameters())
                and all(p.dtype == torch.float32 for p in state.ema.parameters()),
                "train bf16: non-finite or non-fp32 losses, parameters or EMA")
        require(counted == 1, f"train bf16 stem {stem}: {counted} of 3 steps ran the "
                               "wrappers, not the one captured")
        through_bf16(n, counted, per_step, f"train bf16 stem {stem}")
        del model, opt, state, step
    set_stem("never")

    # ---- one step's grads: the card against the CPU's bf16 plain path ----------
    gen2 = torch.Generator().manual_seed(seed + 16)
    two = synthetic_train_batch(gen2, 2, T, m["raw_input_dim_V"], m["raw_input_dim_A"],
                                m["num_classes"], cfg["dataset"]["max_num_events"])
    probe = build_model(cfg, device=dev, seed=seed)
    for mod in probe.modules():
        if hasattr(mod, "drop_prob"):
            mod.drop_prob = 0.0
    cfg32 = copy.deepcopy(cfg)
    cfg32["tpu"]["compute_dtype"] = "float32"
    probe32 = build_model(cfg32, device="cpu", seed=seed)
    probe32.load_state_dict(probe.state_dict())
    for mod in probe32.modules():
        if hasattr(mod, "drop_prob"):
            mod.drop_prob = 0.0
    t0 = time.perf_counter()
    gl, gg = step_grads(copy.deepcopy(probe), cfg, two, dev)
    gms = [step_grads(copy.deepcopy(probe), cfg, bf16_bump(two, gen2, sign), dev)[1]
           for sign in (1, -1, 1, -1)]
    cl, cg = step_grads(copy.deepcopy(probe).cpu(), cfg, two, "cpu")
    _, c32 = step_grads(probe32, cfg32, two, "cpu")
    log(f"train bf16 grads: one step at B=2 on the card (five times: the batch, and one "
        f"input value a video moved one bf16 ulp up, then down, at two draws) and on the CPU "
        f"at bf16 and fp32 in {time.perf_counter() - t0:.1f} s")
    none = {n for n, g in gg.items() if g is None}
    require(none <= ARGMAX_ONLY and none == {n for n, g in cg.items() if g is None},
            f"train bf16 grads: parameters without a grad: {sorted(none)}")
    zero = 1e-6 * max(float(g.norm()) for g in c32.values() if g is not None)
    strict = fallback = 0
    worst = (0.0, "", 0.0, 0.0, 0.0)
    to_fp32 = []
    for n, g in gg.items():
        if g is None:
            continue
        g, c, f = g.cpu(), cg[n], c32[n]
        require(bool(torch.isfinite(g).all()), f"{n}: non-finite grad")
        if float(f.norm()) < zero:               # exactly 0 in exact arithmetic
            require(float(g.norm()) < 100 * zero, f"{n}: grad should vanish")
            continue
        err, gap = rel_err(g, c), rel_err(c, f)
        to_fp32.append(rel_err(g, f) / gap)
        move = max(rel_err(gm[n].cpu(), g) for gm in gms)
        if err <= 0.25 * gap:
            strict += 1
            continue
        fallback += 1
        worst = max(worst, (err / (2 * move), n, err, gap, move))
        require(err <= 2 * move, f"train bf16 grads {n}: card vs CPU bf16 {err:.3e}, CPU "
                                 f"bf16 vs fp32 {gap:.3e}, the card's one-ulp move {move:.3e}")
    # a card that took these grads in fp32 would pass the bounds above where
    # the one-ulp move exceeds half the gap; its grads would sit ~1e-6 from
    # the CPU's fp32 ones, a bf16 step's about a gap away
    bf16ness = sorted(to_fp32)[len(to_fp32) // 2]
    log(f"check train bf16 grads gpu-vs-cpu: loss {gl:.6f} vs {cl:.6f}; {strict} tensors "
        f"within 1/4 of the CPU's bf16-vs-fp32 gap, {fallback} (rounding flips that spread, "
        f"and the CSP gates' argmax, which the card and the CPU score in other orders) within "
        f"2x the card's own move under one input value a video moved by one bf16 ulp (the "
        f"largest of up and down at two draws); worst {worst[1]}: {worst[2]:.3e} against "
        f"move {worst[4]:.3e} (gap {worst[3]:.3e}); median over tensors of the card's "
        f"distance to the CPU's fp32 grads over the CPU's bf16-vs-fp32 gap {bf16ness:.3f}")
    require(bf16ness >= 0.5, "train bf16 grads: the card's grads sit at the CPU's fp32 ones")
    require(abs(gl - cl) <= 1e-2 * abs(cl), f"train bf16 grads: loss {gl} vs {cl}")
    del probe, probe32, gg, gms, cg, c32

    # ---- the train CLI on the bf16 config, from files, with a resume -----------
    with tempfile.TemporaryDirectory() as root:
        synth = make_synthetic_dataset(root, num_videos=64, num_classes=100, min_len=48,
                                       max_len=224, visual_dim=2048, audio_dim=128,
                                       val_fraction=0.5, seed=seed + 16)
        with open(os.path.join(ROOT, "configs", "avel_unav100_bf16.yaml")) as f:
            raw = yaml.safe_load(f)
        raw["dataset"].update(json_file=synth["json_file"], feat_folder=synth["feat_folder"])
        raw.update(train_split=["train"], val_split=["validation"],
                   output_folder=os.path.join(root, "ckpt"))
        raw["opt"].update(epochs=2, warmup_epochs=1)
        raw["train_cfg"]["eval_freq"] = 1
        cfg_yaml = os.path.join(root, "train_bf16.yaml")
        with open(cfg_yaml, "w") as f:
            yaml.safe_dump(raw, f)
        reset()
        t0 = time.perf_counter()
        out = cli.main(cli.parse_args([cfg_yaml, "-p", "4", "-c", "1", "--output", "straight"]))
        torch.cuda.synchronize()
        cli_n = got()
        hist, ts = out["history"], out["train_steps"]
        log(f"train bf16 from files: the train CLI on configs/avel_unav100_bf16.yaml, "
            f"{len(hist)} epochs of 4 steps at B=8 in {time.perf_counter() - t0:.1f} s, "
            f"train losses {[round(h['train_losses']['final_loss'], 5) for h in hist]}, mAP "
            f"{[h['mAP'] for h in hist]}, final {out['final_mAP']!r}; kernel launches {cli_n}, "
            f"train steps {ts}")
        require(len(hist) == 3 and all(finite_losses(h["train_losses"]) for h in hist)
                and all(finite_losses(h["val_losses"]) for h in hist),
                "train bf16 from files: non-finite or missing losses")
        require(ts == {"eager": 1, "captured": 1, "replayed": 11},
                f"train bf16 from files: train steps {ts}, not 1 eager, 1 captured, 11 replayed")
        through_bf16(cli_n, ts["eager"] + ts["captured"], {"mhca": 5, "csp": 10},
                     "train bf16 from files")
        folder = out["ckpt_folder"]
        cli.main(cli.parse_args([cfg_yaml, "-p", "4", "-c", "1", "--output", "resumed",
                                 "--resume", os.path.join(folder, "epoch_001")]))
        a = torch.load(os.path.join(folder, "epoch_002", "state.pt"), map_location="cpu")
        b = torch.load(os.path.join(folder.replace("_straight", "_resumed"), "epoch_002",
                                    "state.pt"), map_location="cpu")
        same = [k for k in a["model"] if torch.equal(a["model"][k], b["model"][k])]
        log(f"check resume bf16: epoch_002 of the run resumed from epoch_001 against the "
            f"straight run's: {len(same)} of {len(a['model'])} parameter tensors bit-identical")
        require(len(same) == len(a["model"]), "train bf16: the resumed run differs")
        torch.backends.cudnn.deterministic = False      # the other phases' setting

    # ---- the bench's train half at fp32 and bf16, in turns ------------------------
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(["--compute-dtype", dtype, "--commit", "unknown", "--seed", str(seed),
                        "--iters", "5"])
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        require(rec["train_dtype"] == dtype, f"the bench trained at {rec['train_dtype']}")
        log(f"time bench train {dtype}: {rec['train_clips_per_sec']:.1f} clips/s (median of "
            f"{len(rec['train_windows'])} windows of {rec['iters']} steps, spread "
            f"{rec['train_spread_pct']:.1f}%), busy share {rec['train_busy_share']:.3f}, peak "
            f"memory {rec['train_peak_memory_gib']:.2f} GiB; eval {rec['value']:.1f} videos/s "
            f"[{smi}]")
    log(f"bf16 train phase: {time.perf_counter() - t_phase:.1f} s")
    return {"mhca_bwd_bf16": launches["never"]["mhca_bwd_bf16"],
            "csp_bwd_bf16": launches["never"]["csp_bwd_bf16"],
            "tblock_bwd_bf16": launches["always"]["tblock_bwd_bf16"],
            "cli": {k: cli_n[k] for k in ("mhca_bwd_bf16", "csp_bwd_bf16",
                                          "tblock_bwd_bf16")}}


def dp_phase(seed: int, smi: str, phase13) -> None:
    """Phase 17, run under torchrun at world size 1 (NCCL on the card), in
    a process of its own: the data-parallel path against the plain one.
    (a) make_train_step with the group, 3 steps at B=8, T=224 in fp32
    (configs/avel_unav100.yaml) and bf16 (avel_unav100_bf16.yaml), against
    make_train_step without a group from the same seed, in this process:
    losses, parameters, EMA and normalizer bit-identical. (b) make_eval_step
    with the group at B=64 (avel_unav100_eval.yaml, fp32 and bf16): the
    gathered detections bit-identical to the plain step's. (c) the train
    CLI on phase 13's files and config (written again from the same seed)
    under this launch: its epoch_002 bit-identical to phase 13's straight
    run (kept in the directory `phase13`) and its mAPs equal; then the eval
    CLI under this launch on that checkpoint. (d) the steps' rates with and
    without the group in turns (plain / dp / dp / plain), and the gradient
    all-reduce at the flagship width by CUDA events. cuDNN runs its
    deterministic algorithms, as the train CLI sets them (its default
    weight grads sum in a varying order)."""
    import torch
    import torch.distributed as dist

    from unav_yolyolva_tpu_torch.core import load_config
    from unav_yolyolva_tpu_torch.data.synthetic import (synthetic_eval_batch,
                                                        synthetic_train_batch)
    from unav_yolyolva_tpu_torch.eval import cli as eval_cli
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_backward
    from unav_yolyolva_tpu_torch.ops.fused_nms import multiclass_soft_nms
    from unav_yolyolva_tpu_torch.parallel import GradSum, make_mesh
    from unav_yolyolva_tpu_torch.train import (cli, create_train_state, make_optimizer,
                                               make_train_step)

    t_phase = time.perf_counter()
    mesh = make_mesh(-1)
    dev = mesh.device
    log(f"dp: torchrun rank {mesh.rank} of {mesh.world_size}, process group "
        f"{dist.get_backend(mesh.group)} on {dev}")
    require(mesh.group is not None and mesh.world_size == 1
            and dist.get_backend(mesh.group) == "nccl" and dev.type == "cuda",
            "phase 17: no NCCL group of one rank on the card")
    torch.backends.cudnn.deterministic = True
    fns = {"mhca": fused_mhca, "csp": fused_csp, "mhca_bwd": mhca_backward,
           "csp_bwd": csp_backward}

    def reset():
        multiclass_soft_nms.launches = 0
        for f in fns.values():
            f.launches = f.bf16_launches = 0

    def got():
        out = {k: f.launches for k, f in fns.items()}
        out.update({f"{k}_bf16": f.bf16_launches for k, f in fns.items()})
        out["nms"] = multiclass_soft_nms.launches
        return out

    def rates(run, per_call, what):
        """{plain, dp}: calls/s x per_call of run(kind) in turns P / DP / DP / P."""
        out = {"plain": [], "dp": []}
        for kind in ("plain", "dp", "dp", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = run(kind)
            torch.cuda.synchronize()
            out[kind].append(n * per_call / (time.perf_counter() - t0))
        log(f"time dp {what}: plain {[round(r, 1) for r in out['plain']]}, with the group "
            f"{[round(r, 1) for r in out['dp']]} (turns plain / dp / dp / plain) [{smi}]")

    # ---- (a) the train step, fp32 and bf16 ----------------------------------------
    for name in ("avel_unav100.yaml", "avel_unav100_bf16.yaml"):
        cfg = load_config(os.path.join(ROOT, "configs", name))
        dtype, m = cfg["tpu"]["compute_dtype"], cfg["model"]
        b, t = cfg["loader"]["batch_size"], m["max_seq_len"]
        g = torch.Generator().manual_seed(seed + 17)
        batches = [{k: v.to(dev) for k, v in synthetic_train_batch(
            g, b, t, m["raw_input_dim_V"], m["raw_input_dim_A"], m["num_classes"],
            cfg["dataset"]["max_num_events"]).items()} for _ in range(3)]
        runs = {}
        for kind in ("plain", "dp"):
            model = build_model(cfg, device=dev, seed=seed)
            opt, _ = make_optimizer(model, cfg["opt"], 100, cfg["train_cfg"]["clip_grad_l2norm"])
            state = create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])
            step = make_train_step(model, opt, cfg, device=dev,
                                   mesh=mesh if kind == "dp" else None)
            reset()
            losses = [step(state, bt, seed) for bt in batches]
            torch.cuda.synchronize()
            runs[kind] = (state, step, losses, got())
        (sp, plain_step, lp, _), (sd, dp_step, ld, n) = runs["plain"], runs["dp"]
        same_losses = all(torch.equal(x[k], y[k]) for x, y in zip(lp, ld) for k in x)
        same_p = [torch.equal(p, q) for p, q in zip(sp.model.parameters(), sd.model.parameters())]
        same_e = [torch.equal(p, q) for p, q in zip(sp.ema.parameters(), sd.ema.parameters())]
        same_norm = torch.equal(sp.loss_normalizer, sd.loss_normalizer)
        log(f"check dp train {dtype}: 3 steps at B={b}, T={t} through the group against "
            f"make_train_step without one: losses {'bit-identical' if same_losses else 'DIFFER'}"
            f" ({[round(float(x['final_loss']), 5) for x in ld]}), {sum(same_p)} of "
            f"{len(same_p)} parameter and {sum(same_e)} of {len(same_e)} EMA tensors "
            f"bit-identical, normalizer {'bit-identical' if same_norm else 'DIFFERS'}; kernel "
            f"launches through the group {n}")
        require(same_losses and all(same_p) and all(same_e) and same_norm,
                f"phase 17: the data-parallel train step at {dtype} left the plain one's bits")
        sfx = "_bf16" if dtype == "bfloat16" else ""
        require(all(n[k + sfx] > 0 for k in fns),
                f"phase 17: the data-parallel train step at {dtype} missed a kernel: {n}")
        state_of = {"plain": (sp, plain_step), "dp": (sd, dp_step)}

        def train(kind, iters=10):
            st, fn = state_of[kind]
            for i in range(iters):
                fn(st, batches[i % 3], seed)
            return iters

        train("plain", 2)
        train("dp", 2)
        rates(train, b, f"train {dtype} clips/s (10 steps at B={b} a turn)")
        if dtype == "float32":
            grad_sum = GradSum(sd.model.parameters(), mesh)
            n_el = grad_sum.flat.numel()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

            def events_ms(fn, iters=20):
                fn()
                torch.cuda.synchronize()
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / iters

            whole = events_ms(grad_sum)
            alone = events_ms(lambda: dist.all_reduce(grad_sum.flat, group=mesh.group))
            host = host_ms(grad_sum)
            log(f"time dp all-reduce: the gradient of {n_el / 1e6:.2f} M fp32 parameters "
                f"({4 * n_el / 1e6:.0f} MB, {len(grad_sum.params)} tensors) over NCCL at world "
                f"size 1, CUDA events over 20 calls: GradSum {whole:.3f} ms (the copy into "
                f"the flat buffer, the all-reduce, the grads made its views; {host:.3f} ms on "
                f"the host clock for one call), the all-reduce alone {alone:.3f} ms [{smi}]")
            del grad_sum

    # ---- (b) the eval step at B=64, fp32 and bf16 --------------------------------
    for dtype in ("float32", "bfloat16"):
        cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100_eval.yaml"))
        cfg["tpu"]["compute_dtype"] = dtype
        m = cfg["model"]
        b, t = cfg["loader"]["batch_size"], m["max_seq_len"]
        model = build_model(cfg, device=dev, seed=seed)
        steps = {"plain": make_eval_step(model, cfg, device=dev),
                 "dp": make_eval_step(model, cfg, mesh=mesh)}
        g = torch.Generator().manual_seed(seed + 18)
        batch = {k: v.to(dev) for k, v in synthetic_eval_batch(
            g, b, t, m["raw_input_dim_V"], m["raw_input_dim_A"]).items()}
        ref = steps["plain"](batch)
        reset()
        dets = steps["dp"](batch)
        torch.cuda.synchronize()
        n = got()
        same = all(torch.equal(ref[k], dets[k]) for k in ref)
        log(f"check dp eval {dtype}: B={b}, T={t}, the detections gathered through the group "
            f"{'bit-identical' if same else 'DIFFER'} to make_eval_step's without one "
            f"({int(dets['valid'].sum())} detections); kernel launches through the group {n}")
        sfx = "_bf16" if dtype == "bfloat16" else ""
        require(same, f"phase 17: the data-parallel eval step at {dtype} left the plain one's "
                      f"bits")
        require(n["nms"] == 1 and n["mhca" + sfx] > 0 and n["csp" + sfx] > 0,
                f"phase 17: the data-parallel eval step at {dtype} missed a kernel: {n}")

        def serve(kind, iters=5):
            for _ in range(iters):
                steps[kind](batch)
            return iters

        serve("plain", 1)
        serve("dp", 1)
        rates(serve, b, f"eval {dtype} videos/s (5 batches of {b} a turn)")
        del model, steps
        torch.cuda.empty_cache()

    # ---- (c) the train CLI and the eval CLI under this launch ------------------------
    with tempfile.TemporaryDirectory() as root:
        cfg_yaml = phase13_files(root, seed)
        reset()
        t0 = time.perf_counter()
        out = cli.main(cli.parse_args([cfg_yaml, "-p", "4", "-c", "1", "--output", "dp"]))
        torch.cuda.synchronize()
        n = got()
        maps = [h["mAP"] for h in out["history"]]
        log(f"dp train CLI: 3 epochs of 8 steps at B=8 under torchrun (world size "
            f"{out['world_size']}) in {time.perf_counter() - t0:.1f} s, mAPs {maps}, final "
            f"{out['final_mAP']!r}; kernel launches {n}")
        require(out["world_size"] == 1 and n["mhca_bwd"] == 5 * 24 and n["csp_bwd"] == 10 * 24
                and n["nms"] == 32, f"phase 17: the train CLI under torchrun ran {n}")
        state = torch.load(os.path.join(out["ckpt_folder"], "epoch_002", "state.pt"),
                           map_location="cpu")
        if phase13 is None:
            log("dp train CLI: no phase 13 run to compare with (--phase13 not given)")
        else:
            ref = torch.load(os.path.join(phase13, "state.pt"), map_location="cpu")
            with open(os.path.join(phase13, "maps.json")) as f:
                ref_maps = json.load(f)
            diff = {part: [k for k in ref[part] if not torch.equal(ref[part][k], state[part][k])]
                    for part in ("model", "ema")}
            leaves = [_leaves(ref["optimizer"]), _leaves(state["optimizer"])]
            same_opt = len(leaves[0]) == len(leaves[1]) and all(
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                for x, y in zip(*leaves))
            log(f"check dp train CLI: epoch_002 against phase 13's straight run: "
                f"{len(ref['model']) - len(diff['model'])} of {len(ref['model'])} model and "
                f"{len(ref['ema']) - len(diff['ema'])} of {len(ref['ema'])} EMA tensors "
                f"bit-identical, optimizer state {'bit-identical' if same_opt else 'DIFFERS'}; "
                f"mAPs {maps} + final {out['final_mAP']!r} against {ref_maps['mAPs']} + "
                f"{ref_maps['final_mAP']!r}")
            require(not diff["model"] and not diff["ema"] and same_opt,
                    f"phase 17: the train CLI under torchrun left phase 13's bits: {diff}")
            require(maps == ref_maps["mAPs"] and out["final_mAP"] == ref_maps["final_mAP"],
                    "phase 17: the train CLI under torchrun got other mAPs than phase 13")
        reset()
        mAP = eval_cli.main(eval_cli.parse_args(
            [cfg_yaml, os.path.join(out["ckpt_folder"], "epoch_002"), "--print-freq", "1000"]))
        n = got()
        batches = -(-64 // load_config(cfg_yaml)["loader"]["batch_size"])
        log(f"dp eval CLI: epoch_002's EMA on the 64 validation videos under torchrun: mAP "
            f"{mAP!r} (the train CLI's validation of epoch 2: {maps[-1]!r}); kernel launches {n}")
        require(math.isfinite(mAP) and 0.0 <= mAP <= 1.0 and n["nms"] == batches,
                f"phase 17: the eval CLI under torchrun gave mAP {mAP}, launches {n}")
    torch.backends.cudnn.deterministic = False
    mesh.close()
    log(f"dp phase: {time.perf_counter() - t_phase:.1f} s")


def _leaves(tree):
    """The leaves of a nested state dict (its keys with them), in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in [k] + _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def data_parallel_phase(seed: int, smi: str, phase13) -> None:
    """Phase 17 from the main run: dp_phase in a process of its own, started
    by torchrun at one rank (`python -m torch.distributed.run --standalone
    --nproc_per_node 1 chip_smoke.py --dp-only`); its lines are logged and
    its failure fails the run."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", os.path.abspath(__file__), "--dp-only", "--seed", str(seed)]
    if phase13 is not None:
        cmd += ["--phase13", phase13]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    for line in proc.stdout.splitlines():
        if line.startswith(("dp", "check dp", "time dp")):
            log(line)
    require(proc.returncode == 0, "phase 17 (data parallel under torchrun) failed:\n"
            + "\n".join((proc.stdout + proc.stderr).splitlines()[-30:]))
    log(f"data-parallel phase (torchrun, one process): {time.perf_counter() - t0:.1f} s")


def host_nms_rows(got_idx, got_score, host, min_score):
    """One row of the single-class kernel against the host scan: None if
    they agree (the same emitted indices in order, scores within rtol 1e-4),
    "near-tie" if each difference is a near-tie of the two programs' float32
    arithmetic (the card's expf and glibc's differ by an ulp or two): an
    index order flipped between emitted scores within 1e-5 of each other, or
    a last slot that one side alone fills with a score at min_score's edge
    (nms_bench.kill_edge); else "differs"."""
    import numpy as np

    from unav_yolyolva_tpu_torch.tools.nms_bench import EDGE_ULPS

    hi, hs = host
    k = int((got_idx >= 0).sum())
    gi, gs = got_idx[:k].astype(np.int64), got_score[:k]
    if k == len(hi) and np.array_equal(gi, hi) and np.allclose(gs, hs, rtol=1e-4, atol=0):
        return None
    lo = np.float32(min_score)
    edge = lo
    for _ in range(EDGE_ULPS):
        edge = np.nextafter(edge, np.float32(np.inf))
    n = min(k, len(hi))
    if abs(k - len(hi)) > 1 or (k != len(hi) and not lo <= (gs if k > n else hs)[n] <= edge):
        return "differs"
    if not np.allclose(np.sort(gs[:n]), np.sort(hs[:n]), rtol=1e-4, atol=0):
        return "differs"
    for j in np.nonzero(gi[:n] != hi[:n])[0]:
        near = [hs[i] for i in (j - 1, j + 1) if 0 <= i < n]
        if not any(abs(float(hs[j]) - float(s)) <= 1e-5 * float(hs[j]) for s in near):
            return "differs"
    return "near-tie"


# phase 18(c): the short accuracy-cost run's epochs on 32 videos, and the
# most its bf16 avg mAP may differ from its fp32 one
ACCURACY_EPOCHS, ACCURACY_DELTA = 30, 0.01


def slice16_phase(seed: int, dev, smi: str, counted) -> None:
    """Phase 18: the host Soft-NMS as a third reference of the single-class
    scan, the bench at the root bench's train configuration with its FLOP
    counts and MFUs, and a short accuracy-cost run through both protocols.

    (a) The C scan (native/nms1d.c through ops/nms_host.py, built with gcc
    under build/host/) against the single-class kernel on the (6400, 1024)
    per-class rows of phase 3's candidates (nms_bench.cases, drawn here from
    a generator of this phase), hard, linear and Gaussian. The two share the
    scan's contract: the host scan takes every lane of a row and returns the
    k slots it emitted, the kernel takes -inf for a dead lane and fills its
    max_out slots with -1 after its last emission; both kill a lane whose
    decayed score falls under min_score, and both emit a row's first winner
    whatever its score. So a row's k kernel slots that hold an index are
    compared with the host's k: the same indices, scores within rtol 1e-4
    (tests/test_nms_host.py's rule); a row that differs only by near-ties
    (host_nms_rows) is counted apart, any other fails.
    (b) tools/bench.py with eval at fp32 B=64 under the candidate cap 2000
    (--nms-candidates: the merged kernel at (64, 2000), as phase 11 serves
    it) and train at B=64 in bf16 (the root bench's train configuration):
    every knob honoured, its FLOP counts, MFUs and vs_baseline present and
    positive, the train half's peak memory; the kernels of both halves
    launched.
    (c) tools/accuracy_cost.py for ACCURACY_EPOCHS epochs on 32 videos:
    fp32_exact served through the fp32 MHCA, CSP and merged NMS kernels,
    bf16_exact through the bf16 MHCA and CSP kernels and the NMS kernel with
    no fp32 MHCA or CSP launch; the fp32 training through the fp32 backward
    kernels; fp32_exact's avg mAP above 0 (the weights learned: at 2 epochs
    it reads 0.0, and so would an evaluator that finds nothing) and
    bf16_exact's within ACCURACY_DELTA of it (the bound PERF.md holds the
    150-epoch run to)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from unav_yolyolva_tpu_torch.ops.fused_nms import soft_nms
    from unav_yolyolva_tpu_torch.ops.nms_host import library_path, soft_nms_host
    from unav_yolyolva_tpu_torch.tools import accuracy_cost, bench, nms_bench

    t_phase = time.perf_counter()

    def reset():
        for fn in counted:
            fn.launches = 0
            if hasattr(fn, "bf16_launches"):
                fn.bf16_launches = 0

    def read():
        out = {fn.__name__: fn.launches for fn in counted}
        out.update({fn.__name__ + "_bf16": fn.bf16_launches for fn in counted
                    if hasattr(fn, "bf16_launches")})
        return out

    # ---- (a) the host scan against the single-class kernel ----------------------
    gen = torch.Generator().manual_seed(seed + 18)
    base = nms_bench.protocol_candidates(gen, dev)
    for label, merged, nargs, kw in nms_bench.cases(base, gen):
        if merged or not label.startswith("soft_nms@6400x1024"):
            continue
        segs, scores = nargs
        ki, ks, _ = soft_nms(segs, scores, **kw)
        torch.cuda.synchronize()
        ki, ks = ki.cpu().numpy(), ks.cpu().numpy()
        s_np, c_np = segs.cpu().numpy(), scores.cpu().numpy()
        t0 = time.perf_counter()
        host = [soft_nms_host(s_np[r], c_np[r], kw["iou_threshold"], kw["sigma"],
                              kw["min_score"], method=kw["method"], max_out=kw["max_out"])
                for r in range(len(c_np))]
        host_s = time.perf_counter() - t0
        verdicts = [host_nms_rows(ki[r], ks[r], host[r], kw["min_score"])
                    for r in range(len(host))]
        err = max((float(np.abs(ks[r, :len(h[1])] - h[1]).max()) for r, h in enumerate(host)
                   if len(h[1]) and verdicts[r] is None), default=0.0)
        differ, ties = verdicts.count("differs"), verdicts.count("near-tie")
        log(f"check nms_host@{label.split('@')[1]}: rows {len(host)}, differing {differ + ties} "
            f"(near-ties {ties}, outside the rule {differ}), emitted "
            f"{sum(len(h[0]) for h in host)}, max_abs_err {err:.3e}; host scan {host_s:.2f} s "
            f"({library_path().name}, gcc) [{smi}]")
        require(differ == 0, f"nms_host: {differ} row(s) of {label} differ from the host scan")
    del base

    # ---- (b) the bench at the root bench's train configuration -------------------
    torch.cuda.empty_cache()
    reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(["--eval-batch", "64", "--compute-dtype", "float32", "--train-batch", "64",
                    "--train-dtype", "bfloat16", "--nms-candidates", "2000", "--iters", "3",
                    "--commit", "unknown", "--seed", str(seed)])
    n = read()
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    for key in ("flops_per_video", "train_flops_per_clip", "mfu_vs_bf16_peak",
                "train_mfu_vs_bf16_peak", "vs_baseline"):
        require(isinstance(rec.get(key), float) and rec[key] > 0,
                f"bench: {key} is {rec.get(key)!r}, not a positive number")
    require(rec["train_batch"] == 64 and rec["train_dtype"] == "bfloat16"
            and rec["batch"] == 64 and rec["dtype"] == "float32"
            and rec["nms_candidates"] == 2000, "bench: the knobs were not honoured")
    log(f"launches bench (eval fp32 B=64 candidates 2000, train bf16 B=64): {n}")
    for name in ("fused_mhca", "fused_csp", "multiclass_soft_nms", "fused_mhca_bf16",
                 "fused_csp_bf16", "mhca_backward_bf16", "csp_backward_bf16"):
        require(n[name] > 0, f"bench: {name} did not launch")
    require(n["mhca_backward"] == n["csp_backward"] == 0,
            "bench: the bf16 train half launched an fp32 backward kernel")
    log(f"time bench eval float32 B=64 candidates 2000: {rec['value']:.1f} videos/s (spread "
        f"{rec['spread_pct']:.1f}%), busy share {rec['busy_share']:.3f}, "
        f"{rec['flops_per_video']:.3f} GFLOP a video, mfu_vs_bf16_peak "
        f"{rec['mfu_vs_bf16_peak']:.4f}, vs_baseline {rec['vs_baseline']:.1f} [{smi}]")
    log(f"time bench train bfloat16 B=64: {rec['train_clips_per_sec']:.1f} clips/s (spread "
        f"{rec['train_spread_pct']:.1f}%), busy share {rec['train_busy_share']:.3f}, peak "
        f"memory {rec['train_peak_memory_gib']:.2f} GiB, {rec['train_flops_per_clip']:.3f} "
        f"GFLOP a clip, train_mfu_vs_bf16_peak {rec['train_mfu_vs_bf16_peak']:.4f} [{smi}]")

    # ---- (c) a short accuracy-cost run ---------------------------------------------
    torch.cuda.empty_cache()
    reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = accuracy_cost.main(["--epochs", str(ACCURACY_EPOCHS), "--videos", "32",
                                     "--seed", str(seed)])
    n = read()
    maps, launches = report["avg_mAP"], report["launches"]
    log(f"accuracy cost ({ACCURACY_EPOCHS} epochs, 32 videos): avg mAP {maps}, delta "
        f"{report['delta_vs_fp32_exact']}, launches by protocol {launches}, in all {n} "
        f"[{smi}]")
    require(n["mhca_backward"] > 0 and n["csp_backward"] > 0,
            "accuracy cost: the fp32 training did not run the backward kernels")
    require(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in maps.values()),
            "accuracy cost: an mAP outside [0, 1]")
    require(maps["fp32_exact"] > 0.0, "accuracy cost: fp32_exact read 0: nothing was learned "
            "or nothing was detected")
    require(abs(report["delta_vs_fp32_exact"]["bf16_exact"]) <= ACCURACY_DELTA,
            f"accuracy cost: bf16_exact is more than {ACCURACY_DELTA} from fp32_exact")
    fp32, bf16 = launches["fp32_exact"], launches["bf16_exact"]
    require(fp32["mhca"] > 0 and fp32["csp"] > 0 and fp32["nms"] > 0
            and fp32["mhca_bf16"] == fp32["csp_bf16"] == 0,
            "accuracy cost: fp32_exact did not serve through the fp32 kernels alone")
    require(bf16["mhca_bf16"] > 0 and bf16["csp_bf16"] > 0 and bf16["nms"] > 0
            and bf16["mhca"] == bf16["csp"] == 0,
            "accuracy cost: bf16_exact did not serve through the bf16 kernels alone")
    log(f"slice 16 phase: {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16-train-only", action="store_true",
                    help="only build, then run phase 16 (the bf16 train step)")
    ap.add_argument("--bf16-fwd-only", action="store_true",
                    help="only build, then run phase 15's kernel checks and lines (the bf16 "
                         "forward kernels, the attention and the products alone)")
    ap.add_argument("--dp-only", action="store_true",
                    help="only build, then run phase 17 (the data-parallel path; run it under "
                         "python -m torch.distributed.run --standalone --nproc_per_node 1, as "
                         "the full run does)")
    ap.add_argument("--phase13", default=None,
                    help="with --dp-only: a directory holding phase 13's epoch_002/state.pt "
                         "and maps.json, which the train CLI under torchrun must repeat")
    ap.add_argument("--slice16-only", action="store_true",
                    help="only build, then run phase 18 (the host Soft-NMS cross-check, the "
                         "bench at the root bench's train configuration, a short "
                         "accuracy-cost run)")
    ap.add_argument("--dependency-only", action="store_true",
                    help="only build, then run phase 14 (the dependency block, its conv "
                         "kernel's check and time lines)")
    ap.add_argument("--bf16-profile-only", action="store_true",
                    help="only build, then profile the bf16 backward kernels (phase 16's "
                         "launch and host lines; phase 16 runs it so, in a process of its "
                         "own)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "unav_yolyolva_tpu_torch")):
        print("chip_smoke: the unav_yolyolva_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from unav_yolyolva_tpu_torch.core import load_config, resolve_device
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops import cuda_build
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch
    from unav_yolyolva_tpu_torch.ops.fused_csp import (csp_backward, csp_backward_reference,
                                                       csp_reference, fused_csp)
    from unav_yolyolva_tpu_torch.ops.gemm_tc import (gelu_erf, gelu_erf_grad, tf32x3_linear,
                                                     tf32x3_products)
    from unav_yolyolva_tpu_torch.ops.fused_mhca import (fused_mhca, mhca_backward,
                                                        mhca_backward_reference,
                                                        mhca_reference)
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)
    from unav_yolyolva_tpu_torch.ops.fused_nms import launch_info, multiclass_soft_nms, soft_nms
    from unav_yolyolva_tpu_torch.ops.fused_tblock import (fused_tblock, tblock_backward,
                                                          tblock_backward_reference,
                                                          tblock_reference)
    from unav_yolyolva_tpu_torch.tools import nms_bench
    from unav_yolyolva_tpu_torch.tools.nms_bench import cuda_ms
    from unav_yolyolva_tpu_torch.tools.grad_gaps import step_grads

    from unav_yolyolva_tpu_torch.ops.conv3_tc import masked_conv3

    counted = (fused_mhca, fused_csp, multiclass_soft_nms, mhca_backward, csp_backward,
               fused_tblock, tblock_backward, soft_nms, masked_conv3)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def counts():
        return {"mhca": fused_mhca.launches, "csp": fused_csp.launches,
                "nms": multiclass_soft_nms.launches, "mhca_bwd": mhca_backward.launches,
                "csp_bwd": csp_backward.launches, "tblock": fused_tblock.launches,
                "tblock_bwd": tblock_backward.launches, "soft_nms": soft_nms.launches,
                "conv3": masked_conv3.launches}

    os.environ.pop("UNAV_FUSED_TBLOCK", None)     # the stem path is set below, per phase
    set_stem("never")

    # ---- 1. the card ------------------------------------------------------
    dev = resolve_device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build()
    secs = time.perf_counter() - t0
    log(f"build: {len(reports)} kernel libraries in {secs:.1f} s (nvcc, sm_90a)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"  ptxas {name}: {line.strip()}")

    if args.dp_only:
        dp_phase(args.seed, smi, args.phase13)
        return 0
    if args.slice16_only:
        slice16_phase(args.seed, dev, smi, counted)
        return 0
    if args.dependency_only:
        dependency_phase(args.seed, dev, smi, torch.Generator().manual_seed(args.seed + 1),
                         reset_counts, counts, {})
        return 0

    # ---- 3. kernels against their plain versions at the real shapes ---------
    gen = torch.Generator().manual_seed(args.seed + 1)
    tcfg = load_config(os.path.join(ROOT, "configs", "avel_unav100.yaml"))
    tm = tcfg["model"]
    B, T = tcfg["loader"]["batch_size"], tm["max_seq_len"]
    if args.bf16_profile_only:
        bf16_backward_profile(build_model(tcfg, device=dev, seed=args.seed), B, T, gen, dev,
                              smi)
        return 0
    if args.bf16_train_only:
        bf16_train_phase(args.seed, dev, smi, gen, {}, B, T)
        return 0
    cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100_eval.yaml"))
    model = build_model(cfg, device=dev, seed=args.seed)
    eval_model = model
    if args.bf16_fwd_only:
        profiled = []
        bf16_forward_checks(model, dev, smi, gen, {}, profiled)
        launch_lines(profiled, smi)
        return 0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: LocPointTransformer width {cfg['model']['embd_dim']}, "
        f"{cfg['model']['num_classes']} classes, T={cfg['model']['max_seq_len']}, "
        f"{n_params / 1e6:.2f} M parameters, fp32")
    results = {}
    with torch.inference_mode():
        for label, key, r, c in (("mhca@64x224x512", "backbone.self_att_V.0.attn", 64, 512),
                                 ("mhca@128x224x256", "backbone.fusion_module.top_down_layers.4.blocks.0", 128, 256)):
            a = mhca_case(model, key, r, 224, c, gen, dev)
            heads = dict(model.named_modules())[key].n_head
            err = compare(label, fused_mhca(*a, heads=heads), mhca_reference(*a, heads=heads))
            ms = cuda_ms(lambda: fused_mhca(*a, heads=heads), 10)
            pms = cuda_ms(lambda: mhca_reference(*a, heads=heads), 5)
            nbytes = 4 * (r * 224 * c * (1 if a[1] is a[0] else 2) + 4 * c * c + 19 * c
                          + r * 224 * c) + r * 224
            results[label] = (err, ms, pms, *bound_ms(mhca_flops(r, 224, c), nbytes,
                                                      mhca_products(r, 224, c)))
            log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                f"bound {results[label][3]:.3f} ms ({results[label][4]}) [{smi}]")

        for label, key, t in (("csp@T224/4h", "backbone.fusion_module.top_down_layers.4", 224),
                              ("csp@T224/8h", "backbone.fusion_module.bottom_up_layers.0", 224),
                              ("csp@T7/8h", "backbone.fusion_module.bottom_up_layers.4", 7),
                              ("csp@T7/4h", "backbone.fusion_module.top_down_layers.1", 7)):
            a, heads = csp_case(model, key, 128, t, gen, dev)
            err = compare(label, fused_csp(*a, attn_heads=heads), csp_reference(*a, attn_heads=heads))
            ms = cuda_ms(lambda: fused_csp(*a, attn_heads=heads), 10)
            pms = cuda_ms(lambda: csp_reference(*a, attn_heads=heads), 5)
            cin, mid, fg, cout = a[0].shape[-1], 256, a[1].shape[-1], 512
            nbytes = 4 * (sum(x.numel() for x in a if x.dtype == torch.float32)
                          + 128 * t * cout) + 128 * t
            results[label] = (err, ms, pms, *bound_ms(
                csp_flops(128, t, cin, mid, 512, fg, cout), nbytes,
                csp_products(128, t, cin, mid, 512, fg, cout)))
            log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                f"bound {results[label][3]:.3f} ms ({results[label][4]}) [{smi}]")

        # the two Soft-NMS scans: merged at (64, 10100), at the capped (64,
        # 2000) and with skewed classes; single-class on the per-class
        # buffers (6400, 1024) for the three methods and at (64, 10100)
        nms_ptxas = nms_bench.ptxas_table(reports.get("nms", ""))
        nms_base = nms_bench.protocol_candidates(gen, dev)
        nms_cases = {}
        for label, merged, nargs, kw in nms_bench.cases(
                nms_base, torch.Generator().manual_seed(args.seed + 3)):
            ki, ks, _ = nms_bench.run(merged, nargs, kw)
            ri, rs, _ = nms_bench.reference(merged, nargs, kw)
            err = nms_bench.check_nms(ki, ks, ri, rs, label, log=log,
                                        min_score=kw["min_score"])
            nms_bench.check_edges(label, merged, nargs, kw, ki, ks, ri, rs, log=log)
            ms = cuda_ms(lambda: nms_bench.run(merged, nargs, kw), 20)
            pms = cuda_ms(lambda: nms_bench.reference(merged, nargs, kw), 3)
            sms = nms_bench.raw_ms(merged, nargs, dict(kw, max_out=1))
            steps = nms_bench.row_steps(ri, kw["max_out"])
            n = nargs[1].shape[1]
            nbytes = sum(x.numel() * 4 for x in nargs) + ki.numel() * 8
            results[label] = (err, ms, pms, *bound_ms(int(steps.sum()) * n, nbytes))
            nms_cases[label] = {"ms": ms, "plain_ms": pms, "bound_ms": results[label][3],
                                "max_abs_err": err, "longest_row_steps": int(steps.max())}
            log(f"time {label}: kernel {ms:.4f} ms, plain {pms:.3f} ms, "
                f"bound {results[label][3]:.4f} ms ({results[label][4]}) [{smi}]")
            log(nms_bench.stage_text(label, ms, sms, steps, launch_info(n, merged=merged),
                                     merged, nms_ptxas) + f" [{smi}]")
        del nms_base

        # the whole TransformerBlock, beside the default path for the same
        # block (the MHCA kernel, cuBLAS fp32 MLP, torch LayerNorm / GELU)
        default_ms = {}
        for label, r in (("tblock@64x224x512", 64), ("tblock@8x224x512", 8)):
            blk, a = tblock_case(model, "backbone.self_att_V.0", r, 224, gen, dev)
            heads, c, hid = blk.attn.n_head, a[0].shape[-1], a[11].shape[0]
            err = compare(label, fused_tblock(*a, heads=heads), tblock_reference(*a, heads=heads))
            ms = cuda_ms(lambda: fused_tblock(*a, heads=heads), 10)
            pms = cuda_ms(lambda: tblock_reference(*a, heads=heads), 5)
            default_ms[label] = cuda_ms(lambda: blk(a[0], a[0], a[1]), 10)
            nbytes = 4 * (2 * r * 224 * c + 2 * r * c + sum(w.numel() for w in a[4:])) + r * 224
            # every product runs on the tensor cores: the MHCA's and the MLP's
            results[label] = (err, ms, pms, *bound_ms(tblock_flops(r, 224, c, hid), nbytes,
                                                      mhca_products(r, 224, c)
                                                      + 4 * r * 224 * c * hid))
            log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, default path "
                f"{default_ms[label]:.3f} ms, bound {results[label][3]:.3f} ms "
                f"({results[label][4]}) [{smi}]")

        # the tensor-core product alone at the CSP final conv's shape (the
        # T=224 concat at 2B=128 into Cout), beside one torch.matmul in fp32
        # (TF32 off: resolve_device), which the port never calls
        m, n, k = 128 * 224, 512, 6 * 256
        xa = torch.randn(m, k, generator=gen).to(dev)
        wa = (torch.randn(n, k, generator=gen) / math.sqrt(k)).to(dev)
        y = tf32x3_linear(xa, wa)
        ref = xa.double() @ wa.double().T
        err_tc = float((y.double() - ref).norm() / ref.norm())
        err_32 = float((torch.matmul(xa, wa.T).double() - ref).norm() / ref.norm())
        same = torch.equal(y, tf32x3_linear(xa, wa))
        log(f"check gemm_tc@{m}x{n}x{k}: norm-wise err vs fp64 {err_tc:.3e}, fp32 torch.matmul "
            f"{err_32:.3e} (allow_tf32={torch.backends.cuda.matmul.allow_tf32}), "
            f"bit-identical on repeat: {same}")
        require(err_tc <= 2 * err_32 and same, "the 3xTF32 product is off its fp32 gate")
        del ref
        ms = cuda_ms(lambda: tf32x3_linear(xa, wa), 20)
        lms = cuda_ms(lambda: torch.matmul(xa, wa.T), 20)
        flops = 2 * m * n * k
        bms, by, ffma = bound_ms(flops, 4 * (m * k + n * k + m * n), flops)
        log(f"time gemm_tc@{m}x{n}x{k}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"library torch.matmul fp32 {lms:.4f} ms, bound {bms:.4f} ms 3xTF32 ({by}), "
            f"{ffma:.4f} ms FFMA [{smi}]")
        del xa, wa, y

        # the backward's layouts alone at the CSP backward's final-conv
        # shapes (T=224, 2B=16 of the train protocol): dcat = g Wfinal (A.B)
        # and Wfinal's grad g^T cat over all rows (A^T.B, split K)
        pb, cout, c6 = 2 * B * T, 512, 6 * 256
        gb_ = torch.randn(pb, cout, generator=gen).to(dev)
        wf = (torch.randn(cout, c6, generator=gen) / math.sqrt(cout)).to(dev)
        cat = torch.randn(pb, c6, generator=gen).to(dev)
        for label, call, mm in (
                (f"gemm_tc_nn@{pb}x{c6}x{cout}", dict(x=gb_, w=wf, trans_b=True),
                 lambda: torch.matmul(gb_, wf)),
                (f"gemm_tc_wgrad@{cout}x{c6}x{pb}", dict(x=gb_, w=cat, trans_a=True,
                                                          trans_b=True),
                 lambda: torch.matmul(gb_.T, cat))):
            y = tf32x3_products([call])[0]
            a64, b64 = call["x"].double(), call["w"].double()
            ref = a64.T @ b64 if call.get("trans_a") else a64 @ b64
            err_tc = float((y.double() - ref).norm() / ref.norm())
            err_32 = float((mm().double() - ref).norm() / ref.norm())
            same = torch.equal(y, tf32x3_products([call])[0])
            log(f"check {label}: norm-wise err vs fp64 {err_tc:.3e}, fp32 torch.matmul "
                f"{err_32:.3e}, bit-identical on repeat: {same}")
            require(err_tc <= 2 * err_32 and same, f"{label}: off its fp32 gate")
            ms = cuda_ms(lambda: tf32x3_products([call]), 20)
            lms = cuda_ms(mm, 20)
            flops = 2 * pb * cout * c6
            bms, by, ffma = bound_ms(flops, 4 * (pb * cout + cout * c6 + pb * c6), flops)
            log(f"time {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), library "
                f"torch.matmul fp32 {lms:.4f} ms, bound {bms:.4f} ms 3xTF32 ({by}), "
                f"{ffma:.4f} ms FFMA [{smi}]")
        del gb_, wf, cat, y, ref

        # the epilogue product alone at the stem block's fc1 (GELU, its input
        # kept beside it: the backward's recompute) and at the train
        # protocol's du (A.B with GELU'): error vs fp64 within 2x that of fp32
        # torch.matmul followed by the same epilogue, the same bits on
        # repeat, the kept input bit-equal to the product without the
        # epilogue; time beside that product's and torch.matmul's
        pf, cf, hf = 64 * T, 512, 4 * 512
        xe = torch.randn(pf, cf, generator=gen).to(dev)
        w1 = (torch.randn(hf, cf, generator=gen) / math.sqrt(cf)).to(dev)
        b1 = (0.1 * torch.randn(hf, generator=gen)).to(dev)
        gy = torch.randn(B * T, cf, generator=gen).to(dev)
        w2 = (torch.randn(cf, hf, generator=gen) / math.sqrt(hf)).to(dev)
        u = torch.randn(B * T, hf, generator=gen).to(dev)
        pre = torch.empty(pf, hf, device=dev)
        for label, call, plain, ref, mm in (
                (f"gemm_tc_gelu@{pf}x{hf}x{cf}", dict(x=xe, w=w1, bias=b1, act="gelu",
                                                       pre_out=pre),
                 dict(x=xe, w=w1, bias=b1),
                 lambda: gelu_erf(xe.double() @ w1.double().T + b1.double()),
                 lambda: gelu_erf(torch.matmul(xe, w1.T) + b1)),
                (f"gemm_tc_nn_gelu_grad@{B * T}x{hf}x{cf}",
                 dict(x=gy, w=w2, trans_b=True, act="gelu_grad", aux=u),
                 dict(x=gy, w=w2, trans_b=True),
                 lambda: (gy.double() @ w2.double()) * gelu_erf_grad(u.double()),
                 lambda: torch.matmul(gy, w2) * gelu_erf_grad(u))):
            y = tf32x3_products([call])[0]
            r64 = ref()
            err_tc = float((y.double() - r64).norm() / r64.norm())
            err_32 = float((mm().double() - r64).norm() / r64.norm())
            same = torch.equal(y, tf32x3_products([call])[0])
            kept = (torch.equal(pre, tf32x3_products([plain])[0])
                    if "pre_out" in call else True)
            log(f"check {label}: norm-wise err vs fp64 {err_tc:.3e}, fp32 torch.matmul + "
                f"epilogue {err_32:.3e}, bit-identical on repeat: {same}, kept input "
                f"bit-equal to the product alone: {kept}")
            require(err_tc <= 2 * err_32 and same and kept, f"{label}: off its fp32 gate")
            del r64
            m_, n_ = y.shape
            flops = 2 * m_ * n_ * cf
            ms = cuda_ms(lambda: tf32x3_products([call]), 20)
            pms = cuda_ms(lambda: tf32x3_products([plain]), 20)
            lms = cuda_ms(mm, 20)
            bms, by, _ = bound_ms(flops, 4 * (m_ * cf + n_ * cf + m_ * n_ * (2 if
                                  "pre_out" in call or "aux" in call else 1)), flops)
            log(f"time {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), the product "
                f"without the epilogue {pms:.4f} ms, torch.matmul + epilogue in torch {lms:.4f} "
                f"ms, bound {bms:.4f} ms 3xTF32 ({by}) [{smi}]")
        del xe, w1, b1, gy, w2, u, pre, y

        profiled = forward_launch_cases(model, gen, dev)     # launch_lines

    # ---- 4. serve three batches of 64 videos --------------------------------
    eval_step = make_eval_step(model, cfg, device=dev)
    mcfg = cfg["model"]
    batches = [synthetic_eval_batch(gen, 64, mcfg["max_seq_len"], mcfg["raw_input_dim_V"],
                                    mcfg["raw_input_dim_A"]) for _ in range(3)]
    reset_counts()
    dets = [eval_step(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"mhca": fused_mhca.launches, "csp": fused_csp.launches,
                "nms": multiclass_soft_nms.launches}
    log(f"serve: 3 batches x 64 videos, kernel launches {launches}")
    if (launches["mhca"] < 15 or launches["csp"] != 30 or launches["nms"] != 3
            or mhca_backward.launches or csp_backward.launches or fused_tblock.launches
            or soft_nms.launches):
        raise AssertionError(f"the main path did not run through every kernel: {launches}")
    n_dets = [check_detections(d, b, mcfg["num_classes"]) for d, b in zip(dets, batches)]
    log(f"serve: detections per batch {n_dets}, finite, sorted, inside [0, duration]")

    cpu_model = copy.deepcopy(model).cpu()
    cpu_step = make_eval_step(cpu_model, cfg, device="cpu")
    cpu_dets = cpu_step({k: v[:2] for k, v in batches[0].items()})
    compare_dets(dets[0], cpu_dets)

    # the same batches with the whole-block stem
    set_stem("always")
    reset_counts()
    fdets = [eval_step(b) for b in batches]
    torch.cuda.synchronize()
    set_stem("never")
    fl = {"tblock": fused_tblock.launches, "mhca": fused_mhca.launches,
          "csp": fused_csp.launches, "nms": multiclass_soft_nms.launches}
    log(f"serve with the whole-block stem: 3 batches x 64 videos, kernel launches {fl}")
    require(fl == {"tblock": 12, "mhca": 3, "csp": 30, "nms": 3},
            f"the whole-block stem did not run through its kernels: {fl}")
    launches["tblock"] = fl["tblock"]
    for fd, d, b in zip(fdets, dets, batches):
        check_detections(fd, b, mcfg["num_classes"])
        set_stem("always")
        compare_dets(fd, d, "whole-block-vs-default",
                     probe=lambda: [eval_step(pb) for pb in perturbed(b, gen)])
        set_stem("never")

    # ---- 4b. serve from files: the eval CLI through the pinned pipeline ------
    serve_from_files(model, args.seed, dev, smi, reset_counts,
                     lambda: {"mhca": fused_mhca.launches, "csp": fused_csp.launches,
                              "nms": multiclass_soft_nms.launches})

    # ---- 5. time the eval step --------------------------------------------
    stems = {"never": [], "always": []}
    for mode in ("never", "always", "always", "never"):     # in turns
        set_stem(mode)
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_step(b)
            torch.cuda.synchronize()
            stems[mode].append(time.perf_counter() - t0)
    set_stem("never")
    for mode, name in (("never", "eval_step"), ("always", "eval_step whole-block stem")):
        times = stems[mode]
        log(f"time {name}: per batch of 64 {[round(x * 1e3, 3) for x in times]} ms, "
            f"{64 * len(times) / sum(times):.1f} videos/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")

    # ---- 6. backward kernels against their plain versions ------------------
    tmodel = build_model(tcfg, device=dev, seed=args.seed)
    for label, key, r, c in ((f"mhca_bwd@{B}x{T}x512", "backbone.self_att_V.0.attn", B, 512),
                             (f"mhca_bwd@{2 * B}x{T}x256",
                              "backbone.fusion_module.top_down_layers.4.blocks.0", 2 * B, 256)):
        a = mhca_case(tmodel, key, r, T, c, gen, dev)
        g = torch.randn(r, T, c, generator=gen).to(dev)
        heads = dict(tmodel.named_modules())[key].n_head
        got = mhca_backward(*a, g, heads=heads)
        again = mhca_backward(*a, g, heads=heads)
        ref = mhca_backward_reference(*a, g, heads=heads)
        err = check_grads(label, got, again, ref, 2)
        if not bool((got[1][1] == 0).all()):
            raise AssertionError(f"{label}: the all-masked row got a non-zero grad")
        ms = cuda_ms(lambda: mhca_backward(*a, g, heads=heads), 10)
        pms = cuda_ms(lambda: mhca_backward_reference(*a, g, heads=heads), 5)
        nbytes = 4 * (5 * r * T * c + 2 * (4 * c * c + 19 * c)) + r * T
        # every product runs on the tensor cores: all but the conv + LN work
        results[label] = (err, ms, pms, *bound_ms(mhca_bwd_flops(r, T, c), nbytes,
                                                  mhca_bwd_flops(r, T, c) - 18 * r * T * c))
        log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
            f"bound {results[label][3]:.3f} ms ({results[label][4]}) [{smi}]")
    for label, key, t in ((f"csp_bwd@T{T}/8h", "backbone.fusion_module.bottom_up_layers.0", T),
                          ("csp_bwd@T7/8h", "backbone.fusion_module.bottom_up_layers.4", 7)):
        a, heads = csp_case(tmodel, key, 2 * B, t, gen, dev)
        g = torch.randn(2 * B, t, 512, generator=gen).to(dev)
        got = csp_backward(*a, g=g, attn_heads=heads)
        again = csp_backward(*a, g=g, attn_heads=heads)
        ref = csp_backward_reference(*a, g=g, attn_heads=heads)
        err = check_grads(label, got, again, ref, 2)
        ms = cuda_ms(lambda: csp_backward(*a, g=g, attn_heads=heads), 10)
        pms = cuda_ms(lambda: csp_backward_reference(*a, g=g, attn_heads=heads), 5)
        cin, fg = a[0].shape[-1], a[1].shape[-1]
        nbytes = 4 * (2 * sum(x.numel() for x in a if x.dtype == torch.float32)
                      + g.numel()) + a[2].numel()
        # every product runs on the tensor cores; the gate's scores (forward
        # and their grads, counted twice) and the MHCAs' conv + LN on FFMA
        flops = csp_bwd_flops(2 * B, t, cin, 256, 512, fg, 512)
        results[label] = (err, ms, pms, *bound_ms(
            flops, nbytes, flops - 3 * 2 * 2 * B * t * 256 * 512 - 3 * 18 * 2 * B * t * 256))
        log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
            f"bound {results[label][3]:.3f} ms ({results[label][4]}) [{smi}]")

    label = f"tblock_bwd@{B}x{T}x512"
    blk, a = tblock_case(tmodel, "backbone.self_att_V.0", B, T, gen, dev)
    heads, c, hid = blk.attn.n_head, a[0].shape[-1], a[11].shape[0]
    g = torch.randn(B, T, c, generator=gen).to(dev)
    got = tblock_backward(*a, g=g, heads=heads)
    again = tblock_backward(*a, g=g, heads=heads)
    ref = tblock_backward_reference(*a, g=g, heads=heads)
    err = check_grads(label, got, again, ref, 1)
    require(bool((got[0][1] == 0).all()), f"{label}: the all-masked row got a non-zero grad")
    ms = cuda_ms(lambda: tblock_backward(*a, g=g, heads=heads), 10)
    pms = cuda_ms(lambda: tblock_backward_reference(*a, g=g, heads=heads), 5)
    nbytes = 4 * (3 * B * T * c + 4 * B * c + 2 * sum(w.numel() for w in a[4:])) + B * T
    # every product runs on the tensor cores: all but the conv + LN work
    flops = tblock_bwd_flops(B, T, c, hid)
    results[label] = (err, ms, pms, *bound_ms(flops, nbytes, flops - 18 * B * T * c))
    log(f"time {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
        f"bound {results[label][3]:.3f} ms ({results[label][4]}) [{smi}]")
    # the block's forward + backward: whole-block kernels vs the default path
    xg = a[0].clone().requires_grad_(True)

    def block_step():
        blk(xg, xg, a[1])[0].backward(g)

    fb = {}
    for mode in ("never", "always", "always", "never"):
        set_stem(mode)
        fb.setdefault(mode, []).append(cuda_ms(block_step, 10))
    set_stem("never")
    log(f"time tblock fwd+bwd@{B}x{T}x512: whole-block kernels {fb['always']} ms, "
        f"default path {fb['never']} ms [{smi}]")
    profiled += backward_launch_cases(tmodel, B, T, gen, dev)
    del tmodel, blk

    # ---- 7. train: 4 checked steps, then timed steps ------------------------
    t_phase = time.perf_counter()
    model = build_model(tcfg, device=dev, seed=args.seed)
    cpu_init = copy.deepcopy(model).cpu()                 # for phase 8
    optimizer, schedule = make_optimizer(model, tcfg["opt"], 2,
                                         tcfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, optimizer, tcfg["train_cfg"]["init_loss_norm"])
    train_step = make_train_step(model, optimizer, tcfg, device=dev)
    tb = [synthetic_train_batch(gen, B, T, tm["raw_input_dim_V"], tm["raw_input_dim_A"],
                                tm["num_classes"], tcfg["dataset"]["max_num_events"])
          for _ in range(4)]
    before = [p.detach().clone() for p in model.parameters()]
    reset_counts()
    losses = [train_step(state, tb[0], args.seed)]
    torch.cuda.synchronize()
    still = all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    losses.append(train_step(state, tb[1], args.seed))
    moved = sum(int((a != p).any()) for a, p in zip(before, model.parameters()))
    losses += [train_step(state, b, args.seed) for b in tb[2:]]
    torch.cuda.synchronize()
    tl = {"mhca": fused_mhca.launches, "csp": fused_csp.launches,
          "mhca_bwd": mhca_backward.launches, "csp_bwd": csp_backward.launches}
    finals = [float(x["final_loss"]) for x in losses]
    nr = ran(train_step)
    log(f"train: 4 steps at B={B}, T={T}, lr {[schedule(i) for i in range(4)]}, "
        f"final_loss {finals}, num_pos {[int(x['num_pos']) for x in losses]}, "
        f"launches {tl} in the {nr} steps that ran the wrappers ({train_step.eager_steps} "
        f"eager, {train_step.captures} captured; {train_step.replays} replays)")
    require(still, "step 1 (lr 0) changed a parameter")
    require(moved > 0, "step 2 moved no parameter")
    log(f"train: step 1 left all {len(before)} parameter tensors bit-identical; "
        f"step 2 moved {moved}")
    require(all(math.isfinite(v) for x in losses for v in map(float, x.values())),
            "a non-finite loss")
    require(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                for p in model.parameters()),
            "a parameter without a finite grad in the update")
    require(nr == 2 and train_step.replays == 3,
            f"train: {nr} eager or captured steps and {train_step.replays} replays, not "
            "2 and 3")
    require(tl["mhca_bwd"] >= 5 * nr and tl["csp_bwd"] == 10 * nr
            and tl["mhca_bwd"] == tl["mhca"] and tl["csp_bwd"] == tl["csp"]
            and not fused_tblock.launches and not tblock_backward.launches,
            f"the train path did not run through every backward kernel: {tl}")
    launches.update(mhca_bwd=tl["mhca_bwd"], csp_bwd=tl["csp_bwd"])
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, tb[i], args.seed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"time train_step: per step of {B} clips {[round(x * 1e3, 3) for x in times]} ms, "
        f"{B * len(times) / sum(times):.1f} clips/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    del state, train_step, optimizer, model

    # ---- 8. one step's grads: CUDA kernels vs the CPU plain path ------------
    for mod in cpu_init.modules():
        if hasattr(mod, "drop_prob"):
            mod.drop_prob = 0.0
    # its own generator: the batch does not shift with the draws of the
    # phases before it
    small = synthetic_train_batch(torch.Generator().manual_seed(args.seed + 2), 2, T,
                                  tm["raw_input_dim_V"], tm["raw_input_dim_A"],
                                  tm["num_classes"], tcfg["dataset"]["max_num_events"])
    gpu_loss, gpu_g = step_grads(copy.deepcopy(cpu_init), tcfg, small, dev)
    cpu_loss, cpu_g = step_grads(copy.deepcopy(cpu_init), tcfg, small, torch.device("cpu"))
    check_step_grads("gpu-vs-cpu", gpu_loss, gpu_g, cpu_loss, cpu_g)
    log(f"train phases: {time.perf_counter() - t_phase:.1f} s")

    # ---- 9. the whole-block stem in training --------------------------------
    t_phase = time.perf_counter()
    set_stem("always")
    model = build_model(tcfg, device=dev, seed=args.seed)
    optimizer, schedule = make_optimizer(model, tcfg["opt"], 2,
                                         tcfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, optimizer, tcfg["train_cfg"]["init_loss_norm"])
    train_step = make_train_step(model, optimizer, tcfg, device=dev)
    before = [p.detach().clone() for p in model.parameters()]
    reset_counts()
    losses = [train_step(state, tb[0], args.seed)]
    torch.cuda.synchronize()
    still = all(torch.equal(a_, p) for a_, p in zip(before, model.parameters()))
    losses += [train_step(state, b, args.seed) for b in tb[1:]]
    torch.cuda.synchronize()
    tl = {"tblock": fused_tblock.launches, "tblock_bwd": tblock_backward.launches,
          "mhca": fused_mhca.launches, "mhca_bwd": mhca_backward.launches,
          "csp": fused_csp.launches, "csp_bwd": csp_backward.launches}
    nr = ran(train_step)
    log(f"train with the whole-block stem: 4 steps at B={B}, final_loss "
        f"{[float(x['final_loss']) for x in losses]}, launches {tl} in the {nr} eager or "
        f"captured steps")
    require(still, "whole-block stem: step 1 (lr 0) changed a parameter")
    require(all(math.isfinite(v) for x in losses for v in map(float, x.values())),
            "whole-block stem: a non-finite loss")
    require(nr == 2 and tl["tblock"] == tl["tblock_bwd"] == 4 * nr
            and tl["mhca"] == tl["mhca_bwd"] == nr and tl["csp"] == tl["csp_bwd"] == 10 * nr,
            f"the whole-block stem did not train through its kernels: {tl}")
    launches["tblock_bwd"] = tl["tblock_bwd"]
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, tb[i], args.seed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"time train_step whole-block stem: per step of {B} clips "
        f"{[round(x * 1e3, 3) for x in times]} ms, {B * len(times) / sum(times):.1f} clips/s "
        f"[{smi}]")
    del state, train_step, optimizer, model
    reset_counts()
    gpu_loss, gpu_g = step_grads(copy.deepcopy(cpu_init), tcfg, small, dev)
    require(fused_tblock.launches == tblock_backward.launches == 4,
            "whole-block stem: the grads step did not run the TBlock kernels")
    cpu_loss, cpu_g = step_grads(copy.deepcopy(cpu_init), tcfg, small, torch.device("cpu"))
    check_step_grads("whole-block-stem gpu-vs-cpu", gpu_loss, gpu_g, cpu_loss, cpu_g)
    set_stem("never")
    log(f"whole-block train phase: {time.perf_counter() - t_phase:.1f} s")

    # ---- 10. the hard and the single-class NMS configurations ---------------
    reset_counts()
    for name, over in (("hard", {"nms_method": "hard"}),
                       ("single-class", {"multiclass_nms": False})):
        ncfg = copy.deepcopy(cfg)
        ncfg["test_cfg"].update(over)
        before = soft_nms.launches
        ndets = make_eval_step(eval_model, ncfg, device=dev)(batches[0])
        torch.cuda.synchronize()
        require(soft_nms.launches == before + 1, f"{name} NMS did not run the soft_nms kernel")
        n = check_detections(ndets, batches[0], mcfg["num_classes"])
        log(f"serve {name} NMS ({ncfg['test_cfg']['nms_method']}, multiclass "
            f"{ncfg['test_cfg']['multiclass_nms']}, voting {ncfg['test_cfg']['voting_thresh']}): "
            f"1 batch x 64 videos, {n} detections")
        compare_dets(ndets, make_eval_step(cpu_model, ncfg, device="cpu")(
            {k: v[:2] for k, v in batches[0].items()}), f"{name}-nms gpu-vs-cpu")
    launches["soft_nms"] = soft_nms.launches

    # ---- 11. the candidate cap before NMS (tpu.nms_max_candidates) ----------
    ncfg = copy.deepcopy(cfg)
    ncfg["tpu"]["nms_max_candidates"] = 2000
    capped = make_eval_step(eval_model, ncfg, device=dev)
    before = multiclass_soft_nms.launches
    cdets = capped(batches[0])
    torch.cuda.synchronize()
    require(multiclass_soft_nms.launches == before + 1,
            "the capped eval step did not run the merged Soft-NMS kernel")
    n = check_detections(cdets, batches[0], mcfg["num_classes"])
    log(f"serve with nms_max_candidates 2000: 1 batch x 64 videos, {n} detections")
    two = {k: v[:2] for k, v in batches[0].items()}
    compare_dets(cdets, make_eval_step(cpu_model, ncfg, device="cpu")(two),
                 "capped gpu-vs-cpu", probe=lambda: [capped(pb) for pb in perturbed(two, gen)])

    # ---- 13. train from files: the train CLI over the pinned Batcher --------
    phase13 = tempfile.mkdtemp(prefix="unav_phase13_")     # its run, for phase 17
    cli_launches = train_from_files(args.seed, dev, smi, reset_counts, counts, keep=phase13)

    # ---- 14. the dependency block --------------------------------------------
    dep = dependency_phase(args.seed, dev, smi, gen, reset_counts, counts, results)

    # ---- 15. the bf16 compute policy on the serving path ----------------------
    bf16_launches = bf16_phase(eval_model, args.seed, dev, smi, gen, results, profiled)

    # ---- 16. the bf16 train step --------------------------------------------------
    bf16_train = bf16_train_phase(args.seed, dev, smi, gen, results, B, T)

    # ---- 17. data parallel: the steps and both CLIs under torchrun, NCCL ----------
    try:
        data_parallel_phase(args.seed, smi, phase13)
    finally:
        shutil.rmtree(phase13, ignore_errors=True)

    # ---- 18. the host Soft-NMS, the bench's knobs and MFUs, the accuracy tool -------
    slice16_phase(args.seed, dev, smi, counted)

    # ---- last: where one call's device time goes, kernel by kernel -------------
    profiled.append(mhca_backward_launch_case(build_model(tcfg, device=dev, seed=args.seed),
                                              B, T, gen, dev))
    launch_lines(profiled, smi)

    def entry(name, label, source, replaces):
        err, ms, pms, bms, by, ffma = results[label]
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], "max_abs_err": err, "ms": ms,
               "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": None,
               "bound_ffma_ms": ffma, "shape": label,
               "launches_train_cli": cli_launches[name],
               "launches_dependency": {"serve": dep["served"][name],
                                       "train": dep["trained"][name]}}
        if dep["new"].get(name):
            out["dependency_cases"] = {
                k: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "bound_ffma_ms"), results[k])) for k in dep["new"][name]}
        return out

    def bf16_entry(name, label, source, replaces):
        """A bf16 kernel (the bf16 instantiation of a TPU kernel): its
        launches on the bf16 served path, its bound at the bf16 peak."""
        err, ms, pms, bms, by, _ = results[label]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": bf16_launches[name], "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None, "shape": label,
                "compute_dtype": "bfloat16", "headers": [pkg + "bf16.cuh"],
                "cases": {k: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by"), results[k][:5]))
                          for k in results if k.startswith(name + "@") and k != label}}

    def bf16_bwd_entry(name, label, source, replaces):
        """A bf16 backward kernel: its launches in phase 16's three bf16
        train steps (the captured one: the others replay the graph; the
        whole-block stem's for the TBlock) and in the bf16 train CLI's run,
        the fp32 backward kernel's ms on the same inputs."""
        err, ms, pms, bms, by, fms = results[label]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": bf16_train[name], "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None, "shape": label,
                "fp32_kernel_ms": fms, "compute_dtype": "bfloat16",
                "launches_train_cli": bf16_train["cli"][name],
                "headers": [pkg + "bf16_bwd.cuh", pkg + "bf16.cuh"],
                "cases": {k: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "fp32_kernel_ms"), results[k]))
                          for k in results if k.startswith(name + "@") and k != label}}

    pkg = "unav_yolyolva_tpu_torch/csrc/"
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": [
        entry("mhca", "mhca@64x224x512", pkg + "mhca.cuh",
              "unav_yolyolva_tpu/ops/pallas_fusion.py:169"),
        entry("csp", "csp@T224/4h", pkg + "csp.cu",
              "unav_yolyolva_tpu/ops/pallas_csp.py:205"),
        dict(entry("nms", "nms@64x10100", pkg + "nms.cu",
                   "unav_yolyolva_tpu/ops/pallas_nms.py:233"),
             design="redesigned: a head per class bucket, the winner's bucket decayed",
             cases={k: v for k, v in nms_cases.items() if k.startswith("nms@")}),
        entry("mhca_bwd", f"mhca_bwd@{B}x{T}x512", pkg + "mhca_bwd.cuh",
              "unav_yolyolva_tpu/ops/pallas_fusion.py:547"),
        entry("csp_bwd", f"csp_bwd@T{T}/8h", pkg + "csp_bwd.cu",
              "unav_yolyolva_tpu/ops/pallas_csp.py:373"),
        dict(entry("tblock", "tblock@64x224x512", pkg + "tblock.cuh",
                   "unav_yolyolva_tpu/ops/pallas_tblock.py:185"),
             default_path_ms=default_ms["tblock@64x224x512"]),
        entry("tblock_bwd", f"tblock_bwd@{B}x{T}x512", pkg + "tblock_bwd.cu",
              "unav_yolyolva_tpu/ops/pallas_tblock.py:299"),
        dict(entry("soft_nms", "soft_nms@6400x1024/m0", pkg + "nms.cu",
                   "unav_yolyolva_tpu/ops/pallas_nms.py:290"),
             design="redesigned: live lanes compacted, the argmax inside the decay pass",
             cases={k: v for k, v in nms_cases.items() if k.startswith("soft_nms@")}),
        dict(bf16_entry("mhca_bf16", "mhca_bf16@64x224x512", pkg + "mhca_bf16.cu",
                        "unav_yolyolva_tpu/ops/pallas_fusion.py:169"),
             design="redesigned: the attention's softmax passes in registers (no logits row "
                    "stored), the product on 128 x 128 tiles with ldmatrix and a four-stage "
                    "ring"),
        dict(bf16_entry("csp_bf16", "csp_bf16@T224/4h", pkg + "csp_bf16.cu",
                        "unav_yolyolva_tpu/ops/pallas_csp.py:205"),
             design="redesigned: the gate's scores on the tensor cores (one scoring function "
                    "with the backward), the redesigned attention and product, guide_fc in "
                    "the main conv's launch (17 launches)"),
        dict(bf16_entry("tblock_bf16", "tblock_bf16@64x224x512", pkg + "tblock_bf16.cu",
                        "unav_yolyolva_tpu/ops/pallas_tblock.py:185"),
             headers=[pkg + "bf16.cuh", pkg + "bf16_wgmma.cuh"],
             design="redesigned: the MLP's products on wgmma fed by TMA (persistent blocks, "
                    "two ping-pong consumer warpgroups, GELU and the residual tail in their "
                    "epilogues), the redesigned MHCA"),
        dict(bf16_bwd_entry("mhca_bwd_bf16", f"mhca_bwd_bf16@{B}x{T}x512",
                            pkg + "mhca_bwd_bf16.cu",
                            "unav_yolyolva_tpu/ops/pallas_fusion.py:547"),
             design="redesigned: the product on a cp.async ring, the attention backward "
                    "fused into two launches"),
        dict(bf16_bwd_entry("csp_bwd_bf16", f"csp_bwd_bf16@T{T}/8h", pkg + "csp_bwd_bf16.cu",
                            "unav_yolyolva_tpu/ops/pallas_csp.py:373"),
             design="redesigned: the product on a cp.async ring, the fused attention "
                    "backward, the masks, taps and transposes read by the loaders, one "
                    "launch of sums"),
        dict(bf16_bwd_entry("tblock_bwd_bf16", f"tblock_bwd_bf16@{B}x{T}x512",
                            pkg + "tblock_bwd_bf16.cu",
                            "unav_yolyolva_tpu/ops/pallas_tblock.py:299"),
             headers=[pkg + "bf16_bwd.cuh", pkg + "bf16.cuh", pkg + "bf16_wgmma.cuh"],
             design="redesigned: fc1, fc2, dy2 W2 and du W1 on the wgmma product fed by TMA "
                    "(u and GELU(u) from fc1's epilogue, du from dy2 W2's: no GELU pass), the "
                    "multiplier sums a block per (sequence, 32 channels) over T, the "
                    "redesigned MHCA backward"),
        {"name": "conv3", "route": "cuda", "source": pkg + "conv3_tc.cu", "replaces": None,
         "why": "the dependency block's two k=3 convs, cuDNN fp32 at the FFMA rate before",
         "launches_dependency": {"serve": dep["served"]["conv3"]},
         "cases": {k: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "bound_ffma_ms", "library_ms", "tf32x3_linear_ms"), v))
                   for k, v in results.items() if k.startswith("conv3@")},
         "design": "3xTF32 on wgmma m64n128k8, the weight's halves and the activation TMA'd "
                   "(the activation once for the three taps), the activation split in "
                   "registers; persistent blocks, a producer and two consumer warpgroups; "
                   "ReLU and row mask in the epilogue"},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
