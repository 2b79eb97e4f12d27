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

On fp32 CUDA features the two k=3 convs run the 3xTF32 `wgmma` kernel of
ops/conv3_tc.py (`masked_conv3`: MaskedConv1D's contract at stride 1
without bias, the ReLU in its epilogue; each weight split into its halves
once a call of the block): the expanding conv a launch a level, the
squeezing conv one launch over every level's sum at the last level (the
small levels' tiles then fill the card: 20.2 ms against 22.3 a launch a
level at B=64, PERF.md); elsewhere (the CPU, bf16 features) they run
`MaskedConv1D` a level. Parameters and state-dict keys are the same either
way.

Spans (utils/profiling.py), once per pyramid level: `unav.dependency.expand`
(the expanding conv and ReLU), `.temporal` (the permute copy and the
temporal branch), `.cooccur` (the co-occurrence branch) and `.squeeze` (the
sum and the squeezing conv; on the kernel's path the last level's holds
the squeezing conv of every level).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import DEPENDENCY_BLOCKS
from ..ops.conv3_tc import conv3_split, masked_conv3
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
        tc = feats[0].is_cuda and feats[0].dtype == torch.float32
        w_in, w_out = self.feature_expand.conv.weight, self.feature_squeeze.conv.weight
        split_in, merged_all = None, []
        out = []
        for lvl, (feat, mask) in enumerate(zip(feats, masks)):
            b, t, _ = feat.shape
            with span("unav.dependency.expand"):
                if tc:
                    split_in = split_in or conv3_split(w_in)
                    h = masked_conv3([feat], w_in, [mask.contiguous()], relu=True,
                                     split=split_in)[0]
                else:
                    h = F.relu(self.feature_expand(feat, mask)[0])
                h = h.reshape(b, t, c, e)
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
                if not tc:
                    out.append(self.feature_squeeze(merged, mask)[0])
                else:
                    merged_all.append(merged.contiguous())
                    if lvl == len(feats) - 1:        # every level's squeeze in one launch
                        out = masked_conv3(merged_all, w_out, [m.contiguous() for m in masks],
                                           relu=False)
        return out, masks
