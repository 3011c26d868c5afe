"""Conv2D, Pool2D, BatchNorm and Flat (the JAX package's ``ops/conv.py``).

Tensors are NCHW and conv kernels OIHW, as in the JAX package. The conv is
``F.conv2d`` (cuDNN on the card), where the JAX package calls
``lax.conv_general_dilated`` (XLA, no Pallas kernel). On the card cuDNN
runs f32 convs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off
(its default is on); a check against f32 arithmetic turns it off.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import ActiMode, OperatorType, PoolType
from flexflow_tpu_torch.ops.base import Op, WeightSpec
from flexflow_tpu_torch.ops.dense import apply_activation


class Conv2D(Op):
    op_type = OperatorType.OP_CONV2D

    def __init__(self, model, name, inputs, out_channels: int,
                 kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                 padding_h: int, padding_w: int,
                 activation: ActiMode = ActiMode.AC_MODE_NONE,
                 groups: int = 1, use_bias: bool = True):
        super().__init__(model, name, inputs)
        self.out_channels = out_channels
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.activation = activation
        self.groups = groups
        self.use_bias = use_bias
        self.in_channels = inputs[0].dims[1]
        self.finalize()

    def output_shapes(self):
        n, c, h, w = self.inputs[0].dims
        oh = (h + 2 * self.padding[0] - self.kernel[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel[1]) // self.stride[1] + 1
        return [(n, self.out_channels, oh, ow)], [self.inputs[0].dtype]

    def weights(self) -> List[WeightSpec]:
        kh, kw = self.kernel
        cin_g = self.in_channels // self.groups
        fan_in = cin_g * kh * kw
        fan_out = (self.out_channels // self.groups) * kh * kw
        ws = [WeightSpec("kernel", (self.out_channels, cin_g, kh, kw),
                         init="glorot", fan=(fan_in, fan_out))]
        if self.use_bias:
            ws.append(WeightSpec("bias", (self.out_channels,), init="zero"))
        return ws

    def forward(self, params, xs, *, training=False):
        y = F.conv2d(xs[0], params["kernel"],
                     params["bias"] if self.use_bias else None,
                     stride=self.stride, padding=self.padding,
                     groups=self.groups)
        return [apply_activation(y, self.activation)]


class Pool2D(Op):
    """Max pool (padding counts as -inf) or average pool (the sum over the
    window, padding as 0, divided by ``kh * kw`` whatever the window
    covers), as the JAX ``reduce_window`` computes them. ``F.max_pool2d``
    / ``F.avg_pool2d`` take padding up to half the kernel; a wider padding
    (the JAX package takes any) is applied by ``F.pad`` first."""

    op_type = OperatorType.OP_POOL2D

    def __init__(self, model, name, inputs, kernel_h, kernel_w,
                 stride_h, stride_w, padding_h, padding_w,
                 pool_type: PoolType = PoolType.POOL_MAX,
                 activation: ActiMode = ActiMode.AC_MODE_NONE):
        super().__init__(model, name, inputs)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.pool_type = pool_type
        self.activation = activation
        self.finalize()

    def output_shapes(self):
        n, c, h, w = self.inputs[0].dims
        oh = (h + 2 * self.padding[0] - self.kernel[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel[1]) // self.stride[1] + 1
        if oh < 1 or ow < 1:
            raise ValueError(
                f"{self.name}: pool2d kernel {self.kernel} stride "
                f"{self.stride} padding {self.padding} on a {h}x{w} input "
                f"yields an empty {oh}x{ow} output — shrink the kernel or "
                f"the stride")
        return [(n, c, oh, ow)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        x = xs[0]
        (kh, kw), (ph, pw) = self.kernel, self.padding
        is_max = self.pool_type == PoolType.POOL_MAX
        if 2 * ph > kh or 2 * pw > kw:
            x = F.pad(x, (pw, pw, ph, ph),
                      value=-math.inf if is_max else 0.0)
            ph = pw = 0
        if is_max:
            y = F.max_pool2d(x, self.kernel, self.stride, (ph, pw))
        else:
            y = F.avg_pool2d(x, self.kernel, self.stride, (ph, pw),
                             count_include_pad=True)
        return [apply_activation(y, self.activation)]


class BatchNorm(Op):
    """BatchNorm over N, H, W of NCHW with running statistics, in the JAX
    package's conventions (not ``F.batch_norm``'s): training normalises by
    the batch mean and the *biased* batch variance, and the running state
    moves as ``new = momentum * old + (1 - momentum) * batch`` (momentum
    0.9 weighs the old value) with the biased variance; eps 1e-5; the ReLU
    comes after the affine. Evaluation normalises by the running state.

    Training runs ``torch.native_batch_norm`` without running statistics
    (it saves only its input and the batch mean and inverse std for the
    backward) and builds the new state from the batch mean and inverse std
    it returns (variance = invstd^-2 - eps), outside autograd. Those
    statistics are f32 whatever the input's dtype; under bf16 compute the
    JAX package takes them with bf16 ``jnp.mean`` / ``jnp.var``, which
    differ from them by bf16 rounding only. The state is f32 (mean and var
    of each channel), never cast to the compute dtype."""

    op_type = OperatorType.OP_BATCHNORM
    stateful = True

    def __init__(self, model, name, inputs, relu: bool = True,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(model, name, inputs)
        self.relu = relu
        self.momentum = momentum
        self.eps = eps
        self.channels = inputs[0].dims[1]
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def weights(self):
        return [WeightSpec("scale", (self.channels,), init="one"),
                WeightSpec("bias", (self.channels,), init="zero")]

    def init_state(self, device=None):
        return self.init_state_for_shapes([self.inputs[0].dims], device)

    def init_state_for_shapes(self, in_shapes, device=None):
        c = in_shapes[0][1]
        return {"mean": torch.zeros(c, dtype=torch.float32, device=device),
                "var": torch.ones(c, dtype=torch.float32, device=device)}

    def forward_stateful(self, params, state, xs, *, training=False,
                         gen=None):
        x = xs[0]
        scale, bias = params["scale"], params["bias"]
        if training:
            y, mean, invstd = torch.native_batch_norm(
                x, scale, bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = torch.reciprocal(torch.square(invstd)) - self.eps
                m = self.momentum
                new_state = {
                    "mean": m * state["mean"] + (1 - m) * mean,
                    "var": m * state["var"] + (1 - m) * var}
        else:
            # the JAX formula on the running state, in f32
            mean, var = state["mean"], state["var"]
            inv = torch.rsqrt(var + self.eps) * scale.float()
            y = ((x.float() - mean[:, None, None]) * inv[:, None, None]
                 + bias.float()[:, None, None]).to(x.dtype)
            new_state = state
        if self.relu:
            y = torch.relu(y)
        return [y], new_state


class Flat(Op):
    op_type = OperatorType.OP_FLAT

    def __init__(self, model, name, inputs):
        super().__init__(model, name, inputs)
        self.finalize()

    def output_shapes(self):
        d = self.inputs[0].dims
        return [(d[0], math.prod(d[1:]))], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [xs[0].reshape(xs[0].shape[0], -1)]
