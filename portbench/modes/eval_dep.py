"""The eval (serving) mode of a configuration with the dependency block
(`use_dependency: True`): modes/eval.py's closed loop, run as it is, with
what it builds from the configuration taken from the block's own modules:

- the weights' shapes and the reference from reference/dependency.py (the
  frozen reference/model.py refuses the block), judged by check.py's
  reference_candidates and compare_eval as they are;
- the step's kernel calls from work_dependency.py (work.step_calls refuses
  the block);
- on a traced run, the program's spans read from the profiler's trace
  (spans.reduce) before the profiler is dropped, recorded under
  `span_trace`: {} or without the block's spans where the program has none.

The mix is handed to eval.py as eval's (its `kind` "eval"), and the record
is eval's, `kind` included, so the eval readers read it as they read
eval's; it adds `span_trace` and `dependency_kernels` (the block's calls
among `kernels`, each with its time alone). eval.py, common.py, check.py
and work.py are not edited: for the length of the run the four names they
look up at call time (common.make_weights, common.reference_model,
common.SubWindow, work.step_calls) are bound to the block's versions, and
restored after.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

from .. import calibrate, common, spans, weights, work, work_dependency
from ..reference import dependency as ref_dep
from . import eval as eval_mode


def make_weights(cfg: Dict, seed: int, dev):
    """common.make_weights over the shapes of the model with the block."""
    return weights.make(ref_dep.shapes(cfg["model"]), common.sub_seed(seed, 1), dev)


def reference_model(cfg: Dict, state, dev):
    model = ref_dep.build(cfg["model"], dev)
    model.load_state_dict(state, strict=True)
    return model


@contextlib.contextmanager
def _with_block(subs: List):
    """The block's versions of the four names, the sub-windows made meanwhile
    appended to `subs`."""

    class SubWindow(common.SubWindow):
        def __init__(self, dev):
            super().__init__(dev)
            self.span_trace: Dict = {}
            subs.append(self)

        def reduce(self) -> None:
            self.span_trace = spans.reduce(self.prof, common.WINDOW_SPAN)
            super().reduce()

    swaps = [(common, "make_weights", make_weights),
             (common, "reference_model", reference_model),
             (common, "SubWindow", SubWindow),
             (work, "step_calls", work_dependency.step_calls)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, value in swaps:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _as_eval(mix: Dict) -> Dict:
    """The mix as eval's (traffic.py makes eval batches for kind "eval")."""
    return dict(mix, kind="eval")


def run(ctx: Dict) -> Dict:
    subs: List = []
    with _with_block(subs):
        record = eval_mode.run(dict(ctx, mix=_as_eval(ctx["mix"])))
    if subs:
        record["span_trace"] = subs[0].span_trace
    if record.get("kernels"):
        block = set(work_dependency.block_calls(ctx["cfg"], ctx["mix"]["batch"]))
        record["dependency_kernels"] = [(c, s) for c, s in record["kernels"] if c in block]
    return record


def calibrate_seed(w: Dict, seed: int, what: List[str], dev) -> List[Dict]:
    """calibrate.py's eval readings of one seed (the program, the control at
    the precision below the configuration's) with the block's weights and
    reference."""
    with _with_block([]):
        return calibrate.eval_seed(dict(w, traffic_file=_as_eval(w["traffic_file"])), seed,
                                   what, False, dev)
