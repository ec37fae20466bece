"""Dense and convolution layers that round as flax does.

flax's ``nn.Dense`` and ``nn.Conv`` with ``dtype=bfloat16`` (the JAX
package's layers) compute the product with f32 accumulation, round it to the
compute dtype, and then add the bias in the compute dtype: two roundings.
``nn.Linear`` / ``nn.Conv2d`` / ``nn.ConvTranspose2d`` add the bias in f32
before their one rounding, which moves ~29% of bf16 outputs by an ulp. These
subclasses keep the parameters and state_dict names of the torch layers (so
upstream checkpoints load strictly) and take the bias after the product.
In f32 the two orders differ only in the last f32 bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x, self.weight, None)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight, None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]
