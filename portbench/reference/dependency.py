"""The plain float32 reference of the UnAV-100 detector with its event-dependency
block (`use_dependency: True`): Geng et al., CVPR 2023, arXiv 2303.12930; the
reference code's libs/modeling/dependency_block.py:6-68, switched on in
configs/avel_unav100.yaml.

The detector is model.py's, built with the block off and untouched; the
block sits between the per-level concat of the visual and audio features
and the heads. At every pyramid level, with x (B, T, D) the concat
(D = 2 * embd_dim), C the classes and E = 128 channels a class:

    h   = ReLU(conv_k(x; W_expand))            (B, T, C * E), no bias, masked;
                                                channel c * E + e is (class c, e)
    tmp = TBlock_time(h as (B * C, T, E))      one head, attention along time
    coo = TBlock_class(h as (B * T, C, E))     one head, attention along classes
    y   = conv_k(tmp + coo; W_squeeze)         (B, T, D), no bias, masked

k = embd_kernel_size (3). Each TBlock is model.py's TransformerBlock (pre-LN,
the masked conv attention, GELU MLP) with one head and an MLP of hidden
width E, as the reference builds its two branches, and the branch scales
of droppath > 0. The block's output replaces the features (no residual).

The reference's two masks are kept as it builds them; neither is what the
equations alone suggest:

  * time: h is flattened b-major (row k = b * C + c) but the mask is tiled
    c-major (`mask.repeat(C, 1, 1)`), so row k takes the mask of video
    k mod B;
  * classes: the flattened (B * T,) mask sends the reference's MaskedConv1D
    into a scalar broadcast, so a frame's whole class row is kept or masked
    together: a padded frame is a row with no valid key, whose attention
    is 0.

Departures from the published code: the forward is the eval forward only
(no stochastic depth is drawn in the block, which the eval path never
does); activations are (B, T, channels) rather than (B, channels, T), the
same numbers in another layout; and, as all of model.py, T must be
max_seq_len. Every product goes through `prec`, so the control lowers the
block's products with the rest.

It imports nothing of the program. `shapes(m)` gives the parameter shapes
that portbench/weights.py draws the run's weights over, in the same key
space as the program's `use_dependency` model, so one state dict loads with
strict=True into both.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from . import model

EMBD = 128          # channels a class (the reference's n_embd)


class TBlock(model.TransformerBlock):
    """One head, MLP hidden width = the block's width (mlp.0, mlp.3)."""

    def __init__(self, c: int, droppath: float):
        super().__init__(c, 1, droppath)
        self.mlp = nn.ModuleList([model.Conv1x1(c, c), nn.Identity(), nn.Identity(),
                                  model.Conv1x1(c, c)])


class DependencyBlock(nn.Module):
    def __init__(self, cin: int, classes: int, k: int, droppath: float, e: int = EMBD):
        super().__init__()
        self.classes, self.e = classes, e
        self.feature_expand = model.ConvBox(cin, classes * e, k, bias=False)
        self.feature_squeeze = model.ConvBox(classes * e, cin, k, bias=False)
        self.temporal_branch = TBlock(e, droppath)
        self.cooccur_branch = TBlock(e, droppath)

    def level(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The block at one level: x (B, T, D), mask (B, T) -> (B, T, D)."""
        b, t, _ = x.shape
        c, e = self.classes, self.e
        h = F.relu(self.feature_expand(x, mask)[0]).reshape(b, t, c, e)
        tmp = h.permute(0, 2, 1, 3).reshape(b * c, t, e)
        tmp = self.temporal_branch(tmp, mask.repeat(c, 1))            # the c-major tiling
        tmp = tmp.reshape(b, c, t, e).permute(0, 2, 1, 3)
        row_mask = mask.reshape(b * t, 1).expand(b * t, c)            # a frame's whole row
        coo = self.cooccur_branch(h.reshape(b * t, c, e), row_mask).reshape(b, t, c, e)
        return self.feature_squeeze((tmp + coo).reshape(b, t, c * e), mask)[0]

    def forward(self, feats: List[torch.Tensor], masks: List[torch.Tensor]
                ) -> List[torch.Tensor]:
        return [self.level(x, m) for x, m in zip(feats, masks)]


class Detector(model.Detector):
    """model.Detector with the block between the concat and the heads; eval
    forward only."""

    def __init__(self, m: Dict):
        if not m["use_dependency"] or m.get("dependency_type",
                                            "DependencyBlock") != "DependencyBlock":
            raise ValueError("the dependency reference needs use_dependency with a "
                             "DependencyBlock")
        super().__init__(dict(m, use_dependency=False))
        c = m["embd_dim"]
        self.dependency = DependencyBlock(2 * c, m["num_classes"], m["embd_kernel_size"],
                                          m["train_cfg"]["droppath"])

    def forward(self, batch):
        mask = batch["mask"]
        v, a, _ = self.alignment(batch["visual"], batch["audio"], mask)
        fv, fa, masks = self.backbone(v, a, mask)
        feats = self.dependency([torch.cat([x, y], -1) for x, y in zip(fv, fa)], masks)
        off = [o.reshape(o.shape[0], o.shape[1], self.classes, 2)
               for o in self.reg_head(feats, masks)]
        return {"cls_logits": self.cls_head(feats, masks), "offsets": off, "masks": masks}


def build(m: Dict, device="cpu") -> Detector:
    with torch.device("meta"):
        det = Detector(m)
    return det.to_empty(device=device)


def shapes(m: Dict) -> Dict[str, torch.Size]:
    """{parameter name: shape} of the model with the block, for weights.make."""
    return {k: v.shape for k, v in build(m, "meta").state_dict().items()}
