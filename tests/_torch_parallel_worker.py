"""One rank of the 2-rank gloo run of tests/test_torch_port_parallel.py.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/_torch_parallel_worker.py IN_DIR OUT_DIR

IN_DIR holds inputs.pt (configs, the JAX weights in the port's layout, the
global train batches) and train.yaml (the train CLI's config over synthetic
files). Each rank writes OUT_DIR/rank<r>.pt with what the test compares:
  train_a   the data-parallel step at the JAX comparison's config (SGD,
            droppath 0): global losses, params after each step;
  train_b   droppath 0.1, inter weight 1.0: the data-parallel step and the
            1-process step on the global batch (losses, grads, parameters
            and normalizer after each step, the EMA after 2 steps), and the
            1-process step 2 from the data-parallel run's weights after its
            step 1 (losses, grads);
  eval      an epoch from files with a partial last batch: detections of
            every batch (data parallel and 1-process), mAP and validation
            losses of both, the output_file written or not;
  cli       the train CLI under this launch: its folder, what this rank
            wrote, its mAPs.
Nothing but the standard library is imported at the top: the Batcher's
worker processes re-import this module."""

import os
import sys


def _np(t):
    return t.detach().cpu().numpy().copy()


def _state(cfg, sd, seed=0):
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import create_train_state, make_optimizer

    model = build_model(cfg, device="cpu", seed=seed if sd is None else None)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    opt, _ = make_optimizer(model, cfg["opt"], 2, cfg["train_cfg"]["clip_grad_l2norm"])
    return create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])


def _train(cfg, sd, batches, mesh, with_grads, seed=0):
    """Two steps (data parallel with `mesh`, else one process on the global
    batches): losses, params (and grads) after each step, the state."""
    from unav_yolyolva_tpu_torch.parallel import shard_batch
    from unav_yolyolva_tpu_torch.train import make_train_step

    state = _state(cfg, sd, seed)
    init = {n: _np(p) for n, p in state.model.named_parameters()}
    step = make_train_step(state.model, state.optimizer, cfg, device="cpu", mesh=mesh)
    out = {"init": init, "losses": [], "params": [], "grads": [], "normalizers": []}
    for b in batches:
        losses = step(state, shard_batch(b, mesh) if mesh is not None else b, seed)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["params"].append({n: _np(p) for n, p in state.model.named_parameters()})
        out["normalizers"].append(_np(state.loss_normalizer))
        if with_grads:
            out["grads"].append({n: _np(p.grad) for n, p in state.model.named_parameters()})
    out["ema"] = {n: _np(p) for n, p in state.ema.named_parameters()}
    out["normalizer"] = _np(state.loss_normalizer)
    return out


def _step2_from(cfg, run, batch, seed):
    """The 1-process step 2 on the global batch from another run's weights
    and normalizer after its step 1: the losses and grads."""
    import torch

    from unav_yolyolva_tpu_torch.train import make_train_step

    state = _state(cfg, None, seed)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(torch.from_numpy(run["params"][0][n]))
    state.loss_normalizer = torch.from_numpy(run["normalizers"][0]).clone()
    state.step = 1
    losses = make_train_step(state.model, state.optimizer, cfg, device="cpu")(state, batch, seed)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: _np(p.grad) for n, p in state.model.named_parameters()}}


def _eval(cfg, sd, mesh, out_dir):
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.eval.metrics import ANETdetection
    from unav_yolyolva_tpu_torch.train.loop import rank_rows, valid_one_epoch

    ds = UnAV100Dataset(False, cfg["val_split"], **cfg["dataset"])
    ev = ANETdetection(ds.json_file, ds.split[0],
                       tiou_thresholds=ds.get_attributes()["tiou_thresholds"])
    state = _state(cfg, sd)
    res = {}
    for name, m in (("dp", mesh), ("single", None)):
        step = make_eval_step(state, cfg, device="cpu", with_losses=True, mesh=m)
        with make_batcher(ds, cfg, False, device="cpu", mesh=m) as batcher:
            dets, ids, blocks = [], [], []
            for batch in batcher:
                blocks.append(int(batch["visual"].shape[0]))
                served = batch if m is None else rank_rows(batch, batcher.pad_to // 2)
                d, _ = step(served)
                n = len(batch["video_id"])
                dets.append({k: _np(v)[:n] for k, v in d.items()})
                ids.extend(batch["video_id"])
            mAP, losses = valid_one_epoch(state, batcher, step, 0, evaluator=ev,
                                          log=lambda *a: None)
            pkl = os.path.join(out_dir, f"dets_{name}_rank{m.rank if m else 'x'}.pkl")
            valid_one_epoch(state, batcher, step, 0, output_file=pkl, log=lambda *a: None)
        res[name] = {"dets": dets, "ids": ids, "mAP": float(mAP), "losses": losses,
                     "blocks": blocks, "wrote_pickle": os.path.exists(pkl)}
    return res


def _cli(yaml_path, out_dir, rank):
    """The train CLI in this process (its make_mesh takes this launch's
    group), with what this rank writes recorded."""
    import builtins

    from unav_yolyolva_tpu_torch.train import checkpoint, cli

    opened, saved = [], []
    real_open, real_write = builtins.open, checkpoint._write

    def spy_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax"):
            opened.append(str(file))
        return real_open(file, mode, *a, **k)

    def spy_write(state, epoch, folder, ckpt_dir, *a, **k):
        saved.append(os.path.basename(ckpt_dir))
        return real_write(state, epoch, folder, ckpt_dir, *a, **k)

    builtins.open, checkpoint._write = spy_open, spy_write
    try:
        out = cli.main(cli.parse_args([yaml_path, "--device", "cpu", "-c", "1", "-p", "1"]))
    finally:
        builtins.open, checkpoint._write = real_open, real_write
    return {"folder": out["ckpt_folder"], "opened": opened, "saved": saved,
            "best_mAP": float(out["best_mAP"]),
            "final_mAP": None if out["final_mAP"] is None else float(out["final_mAP"]),
            "mAPs": [h["mAP"] for h in out["history"]], "world_size": out["world_size"],
            "listing": sorted(os.listdir(out["ckpt_folder"]))}


def main(in_dir, out_dir):
    import torch

    from unav_yolyolva_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    inp = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(2, "cpu")
    res = {"rank": mesh.rank, "world_size": mesh.world_size,
           "backend": torch.distributed.get_backend()}
    res["train_a"] = _train(inp["cfg_a"], inp["sd"], inp["batches"], mesh, False)
    dp = _train(inp["cfg_b"], None, inp["batches"], mesh, True, seed=3)
    res["train_b"] = {"dp": dp,
                      "single": _train(inp["cfg_b"], None, inp["batches"], None, True, seed=3),
                      "single_from_dp": _step2_from(inp["cfg_b"], dp, inp["batches"][1], 3)}
    res["eval"] = _eval(inp["cfg_c"], inp["sd"], mesh, out_dir)
    res["cli"] = _cli(os.path.join(in_dir, "train.yaml"), out_dir, mesh.rank)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    mesh.close()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1], sys.argv[2])
