"""The folded ResNet's float32 3x3 convolution with its epilogue fused in:
y = relu(conv3x3(x, w) + b [+ skip]), stride 1, pad 1, NCHW, in one launch.

The JAX package has no kernel here: XLA lowers its convolutions. On the card
cuDNN runs these float32 convs as FFTs (a filter flip, two forward FFTs, a
complex GEMM and an inverse FFT a conv), and PyTorch adds the bias, the skip
and the ReLU as separate kernels. `conv3x3` launches the hand-written kernel of csrc/conv3x3.cu
instead (float32 FMAs with float32 accumulation, no TF32); `conv3x3_plain`
is its plain PyTorch version (F.conv2d with the bias, then the skip, then
ReLU), which the wrapper runs for CPU tensors only.

The kernel reads the weights packed once as [Cin, 9, Cout] (`pack_weight`,
called by models/network.py fold_bn): `weight` keeps PyTorch's [Cout, Cin,
3, 3] for the plain version, the state dict and checkpoints.

Routing. `takes_kernel` is the rule the folded twin's convs follow
(models/common.py Conv.conv_relu): the kernel only for a folded module's
3x3, stride 1, pad 1 conv with float32 input, compute and output, outside
the mesh's column-parallel layers, at a shape and batch where the kernel
beat cuDNN (`KERNEL_SHAPES`, from tools/conv3x3_cost.py on the card). Every
other conv (the unfolded training network, bfloat16 twins, strided and 1x1
convs, the mesh's convs, the shapes and batches where cuDNN is faster)
keeps PyTorch's conv.
"""

from contextlib import nullcontext

import torch
import torch.nn.functional as F

from muzero_general_tpu_torch.ops.mcts_kernels import _check, _raise_on, _route

# The shapes the kernel takes, (Cin, Cout, H, W) -> the least batch N at
# which it beat cuDNN in tools/conv3x3_cost.py on an H100 (PERF.md section
# 6, row 11): connect4's tower and dynamics convs from 512 samples (at 256
# cuDNN's 45 us beat its 66), the representations' first convs of connect4
# and gomoku from 64 (the least batch timed). Every other shape keeps
# PyTorch's conv: cuDNN was 1.2-3x faster at gomoku's tower (up to 512
# samples), tictactoe's, twentyone's and breakout's, whose few work items
# leave most SMs idle while each takes one SM 16-165 us.
KERNEL_SHAPES = {(64, 64, 6, 7): 512, (65, 64, 6, 7): 512, (3, 64, 6, 7): 64,
                 (3, 128, 11, 11): 64}


def takes_kernel(x_dtype, compute_dtype, out_dtype, kernel_size, stride, padding, mp_group,
                 shape):
    """The routing rule of a folded twin's conv (the callers of Conv.pack and
    Conv.conv_relu are fold_bn twins), a pure predicate: True where it runs
    the kernel. The three dtypes are those of the input, the product and the
    output; kernel_size, stride, padding as nn.Conv2d keeps them; mp_group
    the mesh's column-parallel group (None off the mesh); shape (N, Cin,
    Cout, H, W), or None for any shape and batch. A shape takes the kernel
    where KERNEL_SHAPES has it, from its least batch on."""
    f32 = torch.float32
    if not (x_dtype == f32 and compute_dtype == f32 and out_dtype == f32
            and tuple(kernel_size) == (3, 3) and tuple(stride) == (1, 1)
            and tuple(padding) == (1, 1) and mp_group is None):
        return False
    if shape is None:
        return True
    least = KERNEL_SHAPES.get(tuple(shape[1:]))
    return least is not None and shape[0] >= least


def pack_weight(weight):
    """[Cout, Cin, 3, 3] -> the kernel's [Cin, 9, Cout] (w[ci][3 dy + dx][co]),
    contiguous, a copy."""
    cout, cin = weight.shape[:2]
    return weight.detach().permute(1, 2, 3, 0).reshape(cin, 9, cout).contiguous()


def conv3x3_plain(x, weight, bias, skip=None):
    """relu(conv3x3(x, weight) + bias [+ skip]) in PyTorch ops, float32:
    F.conv2d with the bias (as nn.Conv2d runs it), the skip added, ReLU."""
    y = F.conv2d(x, weight, bias, 1, 1)
    return F.relu(y if skip is None else y + skip)


def conv3x3(x, weight, bias, skip=None, packed=None):
    """relu(conv3x3(x, weight) + bias [+ skip]), stride 1, pad 1: the CUDA
    kernel for CUDA tensors, conv3x3_plain for CPU ones; forward only.

    x [N, Cin, H, W], weight [Cout, Cin, 3, 3], bias [Cout], skip None or
    [N, Cout, H, W]. On CUDA the kernel reads `packed` (pack_weight(weight),
    made once by fold_bn), not `weight`; everything float32 and contiguous.
    A shape the kernel has no launch plan for (csrc/conv3x3.cu plan(): Cout
    not a multiple of 32, a row too wide) raises RuntimeError."""
    device = x.device
    if _route("conv3x3", device) == "cpu":
        return conv3x3_plain(x, weight, bias, skip)
    if x.dim() != 4:
        raise ValueError(f"x must be [N, Cin, H, W], got shape {tuple(x.shape)}")
    n, cin, h, w = x.shape
    cout = bias.shape[0] if bias is not None else -1
    f32 = torch.float32
    _check("x", x, f32, (n, cin, h, w), device)
    _check("packed", packed, f32, (cin, 9, cout), device)
    _check("bias", bias, f32, (cout,), device)
    if skip is not None:
        _check("skip", skip, f32, (n, cout, h, w), device)
    if n == 0:
        return x.new_empty((0, cout, h, w))

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("conv3x3")
    y = torch.empty((n, cout, h, w), dtype=f32, device=device)
    # The raw stream, and no device switch where the tensors' card is the
    # current one: a Stream object and the guard took ~10 us of host time a
    # call on the card's host, about what the launch itself takes.
    index = device.index if device.index is not None else torch.cuda.current_device()
    guard = torch.cuda.device(index) if index != torch.cuda.current_device() else nullcontext()
    with guard:
        rc = lib.conv3x3_forward(x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                                 None if skip is None else skip.data_ptr(), y.data_ptr(),
                                 n, cin, cout, h, w, torch._C._cuda_getCurrentRawStream(index))
    _raise_on(rc, lib.conv3x3_error_string, "conv3x3_forward")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0  # kernel launches, counted where the kernel is launched
