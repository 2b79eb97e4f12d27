"""YAML-over-defaults configuration.

Same semantics as the JAX package's config system: a DEFAULTS tree provides
every knob, the YAML file wins on conflicts and missing keys are filled in
recursively, and `_update_config` fans shared fields out across sections.
One YAML file configures both packages.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import yaml

DEFAULTS: Dict[str, Any] = {
    "init_rand_seed": 1234567891,
    "dataset_name": "unav100",
    "train_split": ("train",),
    "val_split": ("validation",),
    "test_split": ("test",),
    "model_name": "LocPointTransformer",
    "output_folder": "./ckpt",
    "dataset": {
        "json_file": None,
        "feat_folder": None,
        "file_prefix": None,
        "file_ext": ".npy",
        "feat_stride": 8,
        "num_frames": 24,
        "default_fps": 25,
        "num_classes": 100,
        "downsample_rate": 1,
        "max_seq_len": 224,
        "trunc_thresh": 0.5,
        "crop_ratio": [0.9, 1.0],
        "max_num_events": 64,
    },
    "loader": {
        "batch_size": 8,
        "num_workers": 8,
        "prefetch": 4,
    },
    "model": {
        "backbone_type": "convTransformer",
        "dependency_type": "DependencyBlock",
        "backbone_arch": (2, 3, 5),
        "scale_factor": 2,
        "regression_range": [
            (0, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 10000),
        ],
        "input_dim_V": 512,
        "input_dim_A": 512,
        "raw_input_dim_V": 2048,
        "raw_input_dim_A": 128,
        "n_head": 4,
        "embd_kernel_size": 3,
        "embd_dim": 512,
        "embd_with_ln": True,
        "head_dim": 512,
        "head_kernel_size": 3,
        "head_num_layers": 3,
        "head_with_ln": True,
        "use_abs_pe": False,
        "class_aware": True,
        "use_dependency": False,
        "intra_contr_weight": 0.0,
        "inter_contr_weight": 0.02,
        "score_V_weight": 0.0001,
        "score_A_weight": 0.0001,
    },
    "train_cfg": {
        "loss_weight": -1,
        "cls_prior_prob": 0.01,
        "init_loss_norm": 250,
        "clip_grad_l2norm": 1.0,
        "head_empty_cls": [],
        "dropout": 0.0,
        "droppath": 0.1,
        "label_smoothing": 0.0,
        "evaluate": True,
        "eval_freq": 2,
    },
    "test_cfg": {
        "pre_nms_thresh": 0.001,
        "pre_nms_topk": 5000,
        "iou_threshold": 0.1,
        "min_score": 0.01,
        "max_seg_num": 1000,
        "nms_method": "soft",
        "nms_sigma": 0.5,
        "duration_thresh": 0.05,
        "multiclass_nms": True,
        "ext_score_file": None,
        "voting_thresh": 0.75,
    },
    "opt": {
        "type": "AdamW",
        "momentum": 0.9,
        "weight_decay": 0.0,
        "learning_rate": 1e-3,
        "epochs": 30,
        "warmup": True,
        "warmup_epochs": 5,
        "schedule_type": "cosine",
        "schedule_steps": [],
        "schedule_gamma": 0.1,
        "eta_min": 1e-8,
    },
    # section name kept from the JAX package so one YAML serves both; the
    # port reads num_devices (the data-parallel world size: -1 takes
    # torchrun's, any other value must equal it; parallel/mesh.py),
    # compute_dtype (float32 or bfloat16), nms_max_candidates (the eval
    # step's cap before NMS) and approx_topk (the exact top-k either way, as
    # XLA computes lax.approx_max_k off the TPU)
    "tpu": {
        "num_devices": -1,
        "compute_dtype": "float32",
        "nms_max_candidates": 0,
        "approx_topk": False,
    },
}


def _merge(src: Dict, dst: Dict) -> None:
    """Copy keys of `src` absent from `dst` into `dst`, recursing into dicts
    present in both (YAML wins, defaults fill holes)."""
    for key, value in src.items():
        if key in dst:
            if isinstance(value, dict) and isinstance(dst[key], dict):
                _merge(value, dst[key])
        else:
            dst[key] = copy.deepcopy(value)


COMPUTE_DTYPES = ("float32", "bfloat16")


def _update_config(config: Dict) -> Dict:
    """Propagate shared fields between sections; refuse a compute dtype the
    port has no kernels for."""
    if config["tpu"]["compute_dtype"] not in COMPUTE_DTYPES:
        raise ValueError(f"tpu.compute_dtype {config['tpu']['compute_dtype']!r}: the port "
                         f"computes in one of {COMPUTE_DTYPES}")
    config["model"]["num_classes"] = config["dataset"]["num_classes"]
    config["model"]["max_seq_len"] = config["dataset"]["max_seq_len"]
    config["dataset"]["backbone_arch"] = config["model"]["backbone_arch"]
    config["dataset"]["regression_range"] = config["model"]["regression_range"]
    config["dataset"]["class_aware"] = config["model"]["class_aware"]
    config["dataset"]["scale_factor"] = config["model"]["scale_factor"]
    config["model"]["train_cfg"] = config["train_cfg"]
    config["model"]["test_cfg"] = config["test_cfg"]
    return config


def load_config(config_file: str, defaults: Dict = DEFAULTS) -> Dict:
    with open(config_file, "r") as fd:
        config = yaml.load(fd, Loader=yaml.FullLoader)
    if config is None:
        config = {}
    _merge(defaults, config)
    return _update_config(config)


def load_config_dict(overrides: Dict, defaults: Dict = DEFAULTS) -> Dict:
    """Like load_config, from an in-memory dict."""
    config = copy.deepcopy(overrides)
    _merge(defaults, config)
    return _update_config(config)
