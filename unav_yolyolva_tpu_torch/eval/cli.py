"""The evaluation CLI (the port of the root eval.py), on one card or data
parallel over N (one process each, launched by torchrun):

    python -m unav_yolyolva_tpu_torch.eval.cli <config.yaml> <ckpt> [--topk K]
        [--saveonly] [--print-freq N] [--device cpu]
    python -m torch.distributed.run --nproc_per_node N \
        -m unav_yolyolva_tpu_torch.eval.cli <config.yaml> <ckpt> ...

Serves the config's test_split from its feature files: UnAV100Dataset ->
the Batcher (worker processes; pinned batches on CUDA) -> make_eval_step
-> valid_one_epoch -> ANETdetection, and prints the per-tIoU and average
mAP. <ckpt> is a reference-format `.pth.tar` (its state_dict_ema, else
state_dict) or a checkpoint folder of the port or of the JAX package
(msgpack; the latest checkpoint inside it, or the folder itself), whose EMA
weights are served. --topk overrides
test_cfg.max_seg_num; --saveonly writes the detections to
eval_results.pkl beside the checkpoint instead of scoring them. Runs on
CUDA unless --device cpu. Under torchrun (parallel/mesh.py:make_mesh with
tpu.num_devices) each rank loads and serves its row block of every batch,
every rank gathers all rows' detections (the same mAP on each), and rank 0
alone prints and writes.
"""

from __future__ import annotations

import argparse
import os
import time

# The heavy imports live in the functions: the Batcher's worker processes
# re-import this module when it runs as the main module, and importing torch
# costs seconds per process on a card's host.


def load_served_model(cfg, ckpt: str, device, log=print):
    """(the model holding the checkpoint's served weights, the folder the
    checkpoint lies in)."""
    import torch

    from ..models import build_model
    from ..train.checkpoint import (find_latest_checkpoint, is_jax_checkpoint,
                                    load_checkpoint)
    from ..train.optim import make_optimizer
    from ..train.state import create_train_state
    from ..utils.convert import state_dict_from_reference

    model = build_model(cfg, device=device, seed=None)
    if ckpt.endswith(".pth.tar"):
        if not os.path.isfile(ckpt):
            raise FileNotFoundError(f"checkpoint {ckpt} does not exist")
        blob = torch.load(ckpt, map_location="cpu")
        sd = blob.get("state_dict_ema", blob.get("state_dict"))
        if sd is None:
            raise KeyError(f"{ckpt} holds neither state_dict_ema nor state_dict")
        model.load_state_dict(state_dict_from_reference(sd), strict=True)
        log(f"=> loaded reference checkpoint '{ckpt}' "
            f"({'EMA' if 'state_dict_ema' in blob else 'model'} weights)")
        return model, os.path.dirname(ckpt)
    ckpt_dir = find_latest_checkpoint(ckpt)
    if ckpt_dir is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt}")
    optimizer, _ = make_optimizer(model, cfg["opt"], 1, cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, optimizer, cfg["train_cfg"]["init_loss_norm"])
    load_checkpoint(ckpt_dir, state)
    log(f"=> loaded {'JAX ' if is_jax_checkpoint(ckpt_dir) else ''}checkpoint "
        f"'{ckpt_dir}' (EMA weights)")
    return state.ema, ckpt_dir


def main(args) -> float:
    """The average mAP over the test split (0.0 with --saveonly)."""
    from ..core import load_config
    from ..parallel import make_mesh

    if not os.path.isfile(args.config):
        raise FileNotFoundError(f"config file {args.config} does not exist")
    cfg = load_config(args.config)
    if not cfg["test_split"]:
        raise ValueError("the config names no test_split")
    mesh = make_mesh(cfg["tpu"]["num_devices"], args.device)
    try:
        return _evaluate(args, cfg, mesh)
    finally:
        mesh.close()


def _evaluate(args, cfg, mesh) -> float:
    from ..data.dataset import UnAV100Dataset
    from ..data.pipeline import make_batcher
    from ..train.loop import valid_one_epoch
    from .metrics import ANETdetection
    from .step import make_eval_step

    log = print if mesh.is_main else (lambda *a, **k: None)
    device = mesh.device
    if args.topk > 0:
        cfg["test_cfg"]["max_seg_num"] = args.topk

    dataset = UnAV100Dataset(False, cfg["test_split"], **cfg["dataset"])
    if len(dataset) == 0:
        raise ValueError(f"test_split {cfg['test_split']} matched no videos in "
                         f"{cfg['dataset']['json_file']}; check the 'subset' fields")
    model, ckpt_dir = load_served_model(cfg, args.ckpt, device, log)

    evaluator, output_file = None, None
    if args.saveonly:
        output_file = os.path.join(ckpt_dir, "eval_results.pkl")
    else:
        evaluator = ANETdetection(dataset.json_file, dataset.split[0],
                                  tiou_thresholds=dataset.get_attributes()["tiou_thresholds"])
    eval_step = make_eval_step(model, cfg, mesh=mesh)
    log(f"\nStart testing model {cfg['model_name']} on {device}"
        + (f" x {mesh.world_size} ranks" if mesh.world_size > 1 else "") + " ...")
    start = time.time()
    with make_batcher(dataset, cfg, False, mesh=mesh) as batcher:
        mAP, _ = valid_one_epoch(model, batcher, eval_step, -1, evaluator=evaluator,
                                 output_file=output_file,
                                 ext_score_file=cfg["test_cfg"]["ext_score_file"],
                                 print_freq=args.print_freq, log=log)
    log(f"All done! Total time: {time.time() - start:0.2f} sec")
    return float(mAP)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate the audio-visual event localizer "
                                             "(PyTorch port)")
    ap.add_argument("config", type=str)
    ap.add_argument("ckpt", type=str)
    ap.add_argument("--topk", default=-1, type=int)
    ap.add_argument("--saveonly", action="store_true")
    ap.add_argument("--print-freq", default=10, type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
