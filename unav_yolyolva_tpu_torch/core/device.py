"""Device set-up shared by the port's entry points."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA without a card raises instead of falling back.

    On CUDA the fp32 eval protocol is kept exact: TF32 is turned off for
    matrix products and for cuDNN convolutions (cuDNN defaults to TF32).
    cuBLAS's bf16 products are kept from reducing partial sums in bf16
    (PyTorch allows it by default): under the bf16 policy the products
    outside the port's kernels accumulate in fp32, as XLA's do.

    Under torchrun (LOCAL_RANK set) "cuda" is the rank's cuda:LOCAL_RANK,
    which becomes the current device.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None and os.environ.get("LOCAL_RANK"):
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_batch_copier(device: torch.device) -> Callable[[Dict, Sequence[str]], Dict]:
    """copy(batch, keys) -> {key: tensor on `device`}, the host-to-device copy
    of the train and eval steps.

    A batch whose arrays are all pinned host tensors (data/pipeline.py on
    CUDA) is copied with non_blocking=True on a copy stream of the copier's
    own, so the copy overlaps the compute already queued; the compute stream
    waits on an event recorded after the copy, and each copied tensor is
    recorded on the compute stream, where it is used. Any other batch
    (numpy arrays, pageable tensors) takes the pageable copy on the compute
    stream."""
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def copy(batch: Dict, keys: Sequence[str]) -> Dict[str, torch.Tensor]:
        vals = {k: batch[k] for k in keys}
        if copy_stream is None or not all(isinstance(v, torch.Tensor) and v.is_pinned()
                                          for v in vals.values()):
            return {k: torch.as_tensor(v).to(device) for k, v in vals.items()}
        compute = torch.cuda.current_stream(device)
        with torch.cuda.stream(copy_stream):
            # the host allocator records the copy on copy_stream: a pinned
            # block is not handed out again before the copy has read it
            b = {k: v.to(device, non_blocking=True) for k, v in vals.items()}
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        compute.wait_event(copied)
        for v in b.values():        # allocated on copy_stream, used on compute
            v.record_stream(compute)
        return b

    return copy
