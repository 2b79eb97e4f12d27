"""Constants of the benchmark's own tests: the repository's root and the
tiny width at which they drive a run on the CPU."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"dataset": {"num_classes": 5, "max_seq_len": 64, "max_num_events": 8},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "num_classes": 5,
                  "max_seq_len": 64},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20}}
TINY_MIX = {"batch": 4, "pool": 5, "warm": 1, "profile_after_s": 0.2, "profile_steps": 2}
