"""The training CLI (the port of the root train.py), on one card or data
parallel over N (one process each, launched by torchrun):

    python -m unav_yolyolva_tpu_torch.train.cli <config.yaml> [-p N] [-c N]
        [--output NAME] [--resume DIR] [--device cpu]
    python -m torch.distributed.run --nproc_per_node N \
        -m unav_yolyolva_tpu_torch.train.cli <config.yaml> ...

Trains the config's train_split from its feature files: UnAV100Dataset ->
the Batcher (worker processes; pinned batches on CUDA, copied on the train
step's copy stream) -> make_train_step, epoch by epoch. Every eval_freq
epochs and at the last one the EMA weights are validated on val_split
(detections -> ANETdetection mAP, and the epoch-averaged validation
losses); a better mAP writes `model_best` with best_mAP in its meta, and
`epoch_NNN` is written every --ckpt-freq epochs (epoch > 0) and at the last
epoch, into <output_folder>/<name from the config>_<--output or the
time>/, beside config.txt. --resume takes a port checkpoint folder or the
JAX package's (msgpack) and restores its best_mAP. At the end model_best
is reloaded and validated with its RAW weights, not the EMA: the
reference's quirk. max_epochs is opt.early_stop_epochs, else epochs +
warmup_epochs. As the reference does, it seeds numpy and random from
init_rand_seed and sets cuDNN to its deterministic algorithms (for the
process), so that a run resumed from a checkpoint gives the bits of a
straight run. Tensorboard logs go to logs/ where torch.utils.tensorboard
imports, and the epoch losses and mAP to wandb where it imports and its
init succeeds (not under a debugger), as the root train.py logs them. Runs
on CUDA unless --device cpu.

Under torchrun (parallel/mesh.py:make_mesh with tpu.num_devices; NCCL on
cuda:LOCAL_RANK, gloo with --device cpu) every rank builds the same model
from the seed and trains its row block of each global batch; the learning
rate is multiplied by the world size (the root train.py's linear scaling),
which must divide the batch. Rank 0 alone prints the config and the logs
and writes config.txt, tensorboard, wandb and the checkpoints; the folder's
time suffix and the decision to run the final evaluation are rank 0's,
broadcast. The group is destroyed at the end.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time
from pprint import pprint
from typing import Dict

# The heavy imports live in the functions: the Batcher's worker processes
# re-import this module when it runs as the main module, and importing torch
# costs seconds per process on a card's host.


def run_name(cfg: Dict) -> str:
    """The checkpoint folder's name before its suffix, the JAX CLI's."""
    m = cfg["model"]
    return (f"tpu_{cfg['opt']['epochs']}_epochs"
            f"_inter_{m['inter_contr_weight']}_intra_{m['intra_contr_weight']}"
            f"_score_v_{m['score_V_weight']}_score_a_{m['score_A_weight']}"
            f"_batch_{cfg['loader']['batch_size']}")


def _tensorboard(folder: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(os.path.join(folder, "logs"))
    except Exception:       # tensorboard not installed: no logs, as in the JAX CLI
        return None


def _wandb(name: str, args):
    """A wandb run, gated as the root train.py gates it: not under a
    debugger, wandb importable, and its init succeeding; else None."""
    from ..utils.seed import debugger_is_active

    if debugger_is_active():
        return None
    try:
        import wandb

        return wandb.init(project="DEL_UnAV", group="training_alignment_contrastive_yolyolVA_tpu",
                          name=name, config=vars(args))
    except Exception:       # not installed, or no login: no logging, as in the JAX CLI
        return None


def _silent(*_a, **_k) -> None:
    return None


def main(args) -> Dict:
    """Trains; returns {ckpt_folder, best_mAP, final_mAP, history, world_size,
    train_steps}, history one {epoch, train_losses, mAP, val_losses} a
    trained epoch (mAP and val_losses None where the epoch was not
    validated), train_steps the train step's {eager, captured, replayed}
    counts (train/step.py)."""
    from ..core import load_config
    from ..parallel import make_mesh

    if not os.path.isfile(args.config):
        raise FileNotFoundError(f"config file {args.config} does not exist")
    cfg = load_config(args.config)
    mesh = make_mesh(cfg["tpu"]["num_devices"], args.device)
    try:
        return _train(args, cfg, mesh)
    finally:
        mesh.close()


def _train(args, cfg: Dict, mesh) -> Dict:
    import random

    import numpy as np
    import torch

    from ..data.dataset import UnAV100Dataset
    from ..data.pipeline import make_batcher
    from ..eval.metrics import ANETdetection
    from ..eval.step import make_eval_step
    from ..models import build_model
    from ..parallel import barrier, broadcast
    from . import (create_train_state, load_checkpoint, make_optimizer, make_train_step,
                   save_checkpoint, train_one_epoch, valid_one_epoch)

    main_rank = mesh.is_main
    log = print if main_rank else _silent
    if main_rank:
        pprint(cfg)
    device = mesh.device
    world = mesh.world_size
    if cfg["loader"]["batch_size"] % world:
        raise ValueError(f"batch_size {cfg['loader']['batch_size']} must divide over "
                         f"{world} data-parallel ranks")
    cfg["opt"]["learning_rate"] *= world          # the root train.py's linear scaling

    os.makedirs(cfg["output_folder"], exist_ok=True)
    stamp = broadcast(int(time.time()), mesh)    # one folder name on every rank
    suffix = args.output or str(datetime.datetime.fromtimestamp(stamp)).replace(" ", "_")
    ckpt_folder = os.path.join(cfg["output_folder"], f"{run_name(cfg)}_{suffix}")
    os.makedirs(ckpt_folder, exist_ok=True)
    tb_writer = _tensorboard(ckpt_folder) if main_rank else None

    seed = cfg["init_rand_seed"]
    np.random.seed(seed & 0x7FFFFFFF)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    # the reference's fix_random_seed(include_cuda=True): cuDNN's
    # deterministic algorithms. Its default weight-grad algorithms sum in a
    # varying order, which is the one thing that keeps a resumed run from
    # repeating a straight one on the card.
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True

    train_dataset = UnAV100Dataset(True, cfg["train_split"], **cfg["dataset"])
    cfg["train_cfg"]["head_empty_cls"] = train_dataset.get_attributes()["empty_label_ids"]
    cfg["model"]["train_cfg"] = cfg["train_cfg"]
    train_batcher = make_batcher(train_dataset, cfg, True, seed=seed & 0x7FFFFFFF, mesh=mesh)
    evaluate = cfg["train_cfg"]["evaluate"]
    val_batcher = det_eval = None
    if evaluate:
        val_dataset = UnAV100Dataset(False, cfg["val_split"], **cfg["dataset"])
        val_batcher = make_batcher(val_dataset, cfg, False, mesh=mesh)
        det_eval = ANETdetection(val_dataset.json_file, val_dataset.split[0],
                                 tiou_thresholds=val_dataset.get_attributes()["tiou_thresholds"])

    model = build_model(cfg, device=device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"Model parameters: {n_params / 1e6:.2f}M on {device}"
        + (f", rank 0 of {world}" if world > 1 else ""))
    optimizer, schedule = make_optimizer(model, cfg["opt"], len(train_batcher),
                                         cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, optimizer, cfg["train_cfg"]["init_loss_norm"])

    start_epoch, best_mAP = 0, 0.0
    if args.resume:
        restored = load_checkpoint(args.resume, state)
        start_epoch = restored["epoch"] + 1
        # the best-so-far mAP: the first evaluation after the resume must not
        # overwrite a better model_best
        best_mAP = float(restored["meta"].get("best_mAP", 0.0))
        log(f"=> loaded checkpoint '{args.resume}' (epoch {start_epoch - 1}, "
            f"best mAP so far {best_mAP:.4f})")
    wandb_run = None
    if main_rank:
        with open(os.path.join(ckpt_folder, "config.txt"), "w") as fid:
            pprint(cfg, stream=fid)
        wandb_run = _wandb(run_name(cfg), args)

    train_step = make_train_step(model, optimizer, cfg, mesh=mesh)
    eval_step = make_eval_step(state, cfg, with_losses=True, use_ema=True, mesh=mesh)
    barrier("models built", mesh)                 # before the first collective of a step
    max_epochs = cfg["opt"].get("early_stop_epochs",
                                cfg["opt"]["epochs"] + cfg["opt"]["warmup_epochs"])
    history, final_mAP = [], None
    try:
        log(f"\nStart training model {cfg['model_name']} ...")
        for epoch in range(start_epoch, max_epochs):
            _, train_losses = train_one_epoch(state, train_batcher, train_step, seed, epoch,
                                              print_freq=args.print_freq, schedule=schedule,
                                              tb_writer=tb_writer, log=log)
            rec = {"epoch": epoch, "train_losses": train_losses, "mAP": None,
                   "val_losses": None}
            last = epoch == max_epochs - 1
            if evaluate and ((epoch + 1) % cfg["train_cfg"]["eval_freq"] == 0 or last):
                t0 = time.time()
                # every rank holds every row's detections: the same mAP, the
                # same decision to write model_best
                rec["mAP"], rec["val_losses"] = valid_one_epoch(
                    state, val_batcher, eval_step, epoch, evaluator=det_eval,
                    print_freq=args.print_freq, tb_writer=tb_writer, log=log)
                log(f"evaluation done! Total time: {time.time() - t0:0.2f} sec")
                if rec["mAP"] > best_mAP:
                    best_mAP = rec["mAP"]
                    save_checkpoint(state, epoch, ckpt_folder, is_best=True,
                                    extra_meta={"best_mAP": best_mAP}, mesh=mesh)
                if wandb_run is not None:
                    wandb_run.log({"val_epoch_mAP": rec["mAP"]}, step=epoch)
            if wandb_run is not None:
                wandb_run.log({f"train_epoch_{k}": v for k, v in train_losses.items()},
                              step=epoch)
            if last or (args.ckpt_freq > 0 and epoch % args.ckpt_freq == 0 and epoch > 0):
                save_checkpoint(state, epoch, ckpt_folder, file_name=f"epoch_{epoch:03d}",
                                mesh=mesh)
            history.append(rec)

        best_dir = os.path.join(ckpt_folder, "model_best")
        # rank 0 decides (a rank that skipped while others served would
        # leave them waiting in the gathers)
        if broadcast(evaluate and os.path.isdir(best_dir), mesh):
            log("Loading the best model ...")
            restored = load_checkpoint(best_dir, state)
            # the reference's quirk: this pass serves the RAW weights
            final_step = make_eval_step(state, cfg, with_losses=True, use_ema=False, mesh=mesh)
            log(f"\nStart evaluating model {cfg['model_name']} ...")
            t0 = time.time()
            final_mAP, _ = valid_one_epoch(state, val_batcher, final_step, restored["epoch"],
                                           evaluator=det_eval, print_freq=args.print_freq,
                                           tb_writer=tb_writer, log=log)
            log(f"evaluation done! Total time: {time.time() - t0:0.2f} sec")
    finally:
        train_batcher.close()
        if val_batcher is not None:
            val_batcher.close()
        if tb_writer is not None:
            tb_writer.close()
        if wandb_run is not None:
            wandb_run.finish()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"Best mAP: {best_mAP:0.4f}")
    log("All done!")
    return {"ckpt_folder": ckpt_folder, "best_mAP": best_mAP, "final_mAP": final_mAP,
            "history": history, "world_size": world,
            "train_steps": {"eager": train_step.eager_steps, "captured": train_step.captures,
                            "replayed": train_step.replays}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train the audio-visual event localizer "
                                             "(PyTorch port)")
    ap.add_argument("config", metavar="DIR", help="path to a config file")
    ap.add_argument("-p", "--print-freq", default=20, type=int)
    ap.add_argument("-c", "--ckpt-freq", default=20, type=int)
    ap.add_argument("--output", default="", type=str)
    ap.add_argument("--resume", default=None, type=str, metavar="PATH")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
