"""The optional event-dependency block (`use_dependency: True`), the JAX
package's models/dependency.py: the fused features of each pyramid level
are expanded to n_embd channels per class, a temporal TransformerBlock runs
over (B * C, T, n_embd) and a co-occurrence TransformerBlock over
(B * T, C, n_embd), the two are summed and squeezed back to the input width.

Both blocks have one head and a hidden width of n_embd, and run the MHCA
kernel (or, with UNAV_FUSED_TBLOCK=always, the whole-block kernel) at rows
of length T and of length C. The reference's two mask quirks are kept:
  * the temporal branch flattens the features b-major (row k = b * C + c)
    but tiles the mask c-major, so row k gets the mask of sample k mod B;
  * the co-occurrence branch keeps or zeroes each frame's whole class row:
    a padded frame is a row without a valid key, whose attention is
    exactly 0.

Spans (utils/profiling.py), once per pyramid level: `unav.dependency.expand`
(the expanding conv and ReLU), `.temporal` (the permute copy and the
temporal branch), `.cooccur` (the co-occurrence branch) and `.squeeze` (the
sum and the squeezing conv).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import DEPENDENCY_BLOCKS
from ..utils.profiling import span
from .blocks import MaskedConv1D, TransformerBlock


@DEPENDENCY_BLOCKS.register("DependencyBlock")
class DependencyBlock(nn.Module):
    def __init__(self, in_channel: int, n_embd: int = 128, n_embd_ks: int = 3,
                 num_classes: int = 100, path_pdrop: float = 0.1, n_head: int = 1):
        super().__init__()
        self.n_embd, self.num_classes = n_embd, num_classes
        self.feature_expand = MaskedConv1D(in_channel, n_embd * num_classes, n_embd_ks,
                                           bias=False)
        self.feature_squeeze = MaskedConv1D(n_embd * num_classes, in_channel, n_embd_ks,
                                            bias=False)
        self.temporal_branch = TransformerBlock(n_embd, n_head, path_pdrop=path_pdrop,
                                                n_hidden=n_embd)
        self.cooccur_branch = TransformerBlock(n_embd, n_head, path_pdrop=path_pdrop,
                                               n_hidden=n_embd)

    def forward(self, feats: List[torch.Tensor], masks: List[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        c, e = self.num_classes, self.n_embd
        out = []
        for feat, mask in zip(feats, masks):
            b, t, _ = feat.shape
            with span("unav.dependency.expand"):
                h = F.relu(self.feature_expand(feat, mask)[0]).reshape(b, t, c, e)
            with span("unav.dependency.temporal"):
                tmp = h.permute(0, 2, 1, 3).reshape(b * c, t, e)
                tmp_out, _ = self.temporal_branch(tmp, tmp, mask.repeat(c, 1), generator)
                tmp_out = tmp_out.reshape(b, c, t, e).permute(0, 2, 1, 3)
            with span("unav.dependency.cooccur"):
                coo = h.reshape(b * t, c, e)
                coo_mask = mask.reshape(b * t, 1).expand(b * t, c)
                coo_out, _ = self.cooccur_branch(coo, coo, coo_mask, generator)
            with span("unav.dependency.squeeze"):
                merged = (tmp_out + coo_out.reshape(b, t, c, e)).reshape(b, t, c * e)
                out.append(self.feature_squeeze(merged, mask)[0])
        return out, masks
