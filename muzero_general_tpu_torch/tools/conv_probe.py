"""The conv probe (port of tools/conv_probe.py): a 3x3 SAME convolution with
bias and ReLU as two hand-written CUDA kernels, held against the library
convolution at the board games' recurrent-inference shapes.

The default shape [64, 11, 11, 128] bf16 is gomoku's recurrent-inference
conv (64 lanes, 11 x 11 board, 128 channels). Both kernels
(csrc/conv_probe.cu) compute y = relu(conv3x3(x, w) + b) on an NHWC
activation padded once, xp [B, H + 2, W + 2, C], with bfloat16 (or float32)
operands and float32 accumulation, and store y once in the input dtype:

- `conv_9dot(xp, w9, b)`: nine shifted [B*H*W, C] @ [C, C] products, tap by
  tap, on w9 [9, C, C] (the TPU kernel `_conv_kernel`);
- `conv_im2col(xp, w_flat, b)`: one [tile, 9C] @ [9C, C] product over a
  patch tile gathered in shared memory, on w_flat [9C, C] (the TPU kernel
  `_conv_kernel_im2col`).

Each wrapper launches its kernel on a CUDA tensor and counts the launch,
and runs its plain PyTorch version (`conv_9dot_plain`, `conv_im2col_plain`,
the same float32 accumulation) on a CPU tensor. `library_conv` is the
counterpart of the probe's `xla_conv`: cuDNN through F.conv2d, the
yardstick; nothing on the port's paths calls it.

Usage:
    python -m muzero_general_tpu_torch.tools.conv_probe [--B 64] [--H 11] \\
        [--W 11] [--C 128] [--iters 50] [--dtype bfloat16] [--device cuda]

It checks each kernel against the library conv (max |d| / max |ref| < 2e-2,
the probe's bound) and, on the card, times `--iters` chained applications
(y = conv(y)) of each engine captured in one CUDA graph, the counterpart of
the probe's one-dispatch lax.scan, printing us/conv and TFLOP/s
(2 * B * H * W * 9 * C * C operations a conv). On the CPU it checks and
stops, as the probe's --interpret does.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.models.common import FullPrecision
from muzero_general_tpu_torch.ops.mcts_kernels import _check, _raise_on, _route

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LIBRARY_TOL = 2e-2  # the probe's bound on max |d| / max |ref| (tools/conv_probe.py:143-145)


def _epilogue(acc, b, dtype, shape, out):
    """relu(acc + b) in float32, cast once to `dtype`, as [B, H, W, C]; into
    `out` (its interior where it is padded) when given."""
    B, H, W, C = shape
    y = torch.relu(acc + b.reshape(1, C).float()).to(dtype).reshape(B, H, W, C)
    if out is None:
        return y
    (out[:, 1:-1, 1:-1] if out.shape[1] == H + 2 else out).copy_(y)
    return out


def _taps(xp):
    """The nine shifted views of xp [B, H + 2, W + 2, C] as [B*H*W, C]
    float32 (exact for bfloat16), in tap order di * 3 + dj."""
    B, Hp, Wp, C = xp.shape
    H, W = Hp - 2, Wp - 2
    return [xp[:, di:di + H, dj:dj + W, :].reshape(B * H * W, C).float()
            for di in range(3) for dj in range(3)]


def conv_9dot_plain(xp, w9, b, out=None):
    """The 9-dot kernel's plain version: nine float32 products of the
    shifted rows and the tap weights, summed tap by tap, then
    relu(acc + b) cast once to xp's dtype. Returns [B, H, W, C] (or `out`)."""
    B, Hp, Wp, C = xp.shape
    acc = torch.zeros((B * (Hp - 2) * (Wp - 2), C), dtype=torch.float32, device=xp.device)
    for tap, rows in enumerate(_taps(xp)):
        acc = acc + rows @ w9[tap].float()
    return _epilogue(acc, b, xp.dtype, (B, Hp - 2, Wp - 2, C), out)


def conv_im2col_plain(xp, w_flat, b, out=None):
    """The im2col kernel's plain version: the patch matrix [B*H*W, 9C]
    times w_flat [9C, C] in one float32 product, then relu(acc + b) cast
    once to xp's dtype."""
    B, Hp, Wp, C = xp.shape
    acc = torch.cat(_taps(xp), dim=1) @ w_flat.float()
    return _epilogue(acc, b, xp.dtype, (B, Hp - 2, Wp - 2, C), out)


def _launch(fn_name, wrapper, plain, xp, w, b, w_shape, out):
    device = xp.device
    route = _route(fn_name, device)
    if xp.dim() != 4 or xp.dtype not in DTYPES.values():
        raise ValueError(f"xp must be [B, H + 2, W + 2, C] bfloat16 or float32, got "
                         f"{tuple(xp.shape)} {xp.dtype}")
    B, Hp, Wp, C = xp.shape
    H, W = Hp - 2, Wp - 2
    if H < 1 or W < 1 or C % 16:
        raise ValueError(f"xp {tuple(xp.shape)}: needs H, W >= 1 and C a multiple of 16")
    _check("xp", xp, xp.dtype, tuple(xp.shape), device)
    _check("w", w, xp.dtype, w_shape(C), device)
    _check("b", b, xp.dtype, (1, C), device)
    if out is not None:
        if tuple(out.shape) not in ((B, H, W, C), (B, Hp, Wp, C)):
            raise ValueError(f"out must be [B, H, W, C] or padded [B, H + 2, W + 2, C], got "
                             f"{tuple(out.shape)}")
        _check("out", out, xp.dtype, tuple(out.shape), device)
    if route == "cpu":
        return plain(xp, w, b, out)
    if out is None:
        out = torch.empty((B, H, W, C), dtype=xp.dtype, device=device)
    for name, t in (("xp", xp), ("w", w), ("out", out)):
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("conv_probe")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(xp.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   B, H, W, C, int(out.shape[1] == Hp),
                                   int(xp.dtype == torch.bfloat16), stream)
    _raise_on(rc, lib.conv_probe_error_string, fn_name)
    wrapper.launches += 1
    return out


def conv_9dot(xp, w9, b, out=None):
    """relu(conv3x3 + b) by nine shifted products: the CUDA kernel for CUDA
    tensors, conv_9dot_plain for CPU ones. xp [B, H + 2, W + 2, C], w9
    [9, C, C], b [1, C], one dtype (bfloat16 or float32), contiguous; C a
    multiple of 16 on the card. out: optional [B, H, W, C], or a padded
    [B, H + 2, W + 2, C] whose interior is written (its border untouched).
    Returns y [B, H, W, C] (or out)."""
    return _launch("conv_probe_9dot", conv_9dot, conv_9dot_plain, xp, w9, b,
                   lambda C: (9, C, C), out)


def conv_im2col(xp, w_flat, b, out=None):
    """The same by one im2col product: w_flat [9C, C] (w9 reshaped)."""
    return _launch("conv_probe_im2col", conv_im2col, conv_im2col_plain, xp, w_flat, b,
                   lambda C: (9 * C, C), out)


conv_9dot.launches = 0  # kernel launches, counted where the kernel is launched
conv_im2col.launches = 0


def library_weight(w):
    """The HWIO kernel [3, 3, C, C] as F.conv2d takes it: OIHW in the
    channels-last layout cuDNN runs NHWC convolutions with (laid out once,
    as a compiled XLA conv holds its weights)."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def library_conv(x, w_lib, b):
    """The counterpart of the probe's xla_conv: relu(conv3x3(x) + b) by
    cuDNN, x [B, H, W, C] (unpadded; F.conv2d pads), w_lib from
    library_weight, b [C]; the convolution accumulates in float32 (in
    full float32 for float32 inputs: no TF32) and rounds its output (bias
    added) to x's dtype. Returns [B, H, W, C]."""
    with FullPrecision():
        y = F.conv2d(x.permute(0, 3, 1, 2), w_lib, b, padding=1)
    return torch.relu_(y).permute(0, 2, 3, 1)


def relative_error(got, ref):
    """max |got - ref| / max |ref|, in float32 (the probe's measure)."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / (ref.abs().max() + 1e-9))


def _chain_us(step, iters, reps=5):
    """Device time of one application of `step` (one conv), `iters` chained
    applications captured in one CUDA graph, replayed `reps` times between
    CUDA events after a warm replay."""
    step()  # warm-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            step()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / (reps * iters)


def probe_inputs(B, H, W, C, dtype, device, seed=0):
    """The probe's inputs, drawn as tools/conv_probe.py draws them: x [B, H,
    W, C], w [3, 3, C, C] (HWIO), b [1, C]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)) * 0.1
    w = rng.normal(size=(3, 3, C, C)) * 0.05
    b = rng.normal(size=(1, C)) * 0.1
    return tuple(torch.tensor(a, dtype=torch.float32).to(device=device, dtype=dtype)
                 for a in (x, w, b))


def main(argv=None):
    """The probe's entry point; returns {"errors": {engine: max rel err vs the
    library conv}, "us_per_conv": {engine: us} (on the card), "tflops"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--H", type=int, default=11)
    ap.add_argument("--W", type=int, default=11)
    ap.add_argument("--C", type=int, default=128)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--blocks", type=int, default=2,
                    help="accepted for the TPU probe's flags: it cut that kernel's batch "
                         "grid, and has no meaning here (a CUDA block owns a pixel tile)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, H, W, C = args.B, args.H, args.W, args.C
    dtype = DTYPES[args.dtype]
    x, w, b = probe_inputs(B, H, W, C, dtype, device)
    w9, w_flat, w_lib = w.reshape(9, C, C), w.reshape(9 * C, C), library_weight(w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))

    # Correctness: one application each against the library conv.
    route = "CUDA kernel" if device.type == "cuda" else "plain version"
    with torch.no_grad():
        ref = library_conv(x, w_lib, b[0])
        engines = {"conv_9dot": lambda t, o=None: conv_9dot(t, w9, b, o),
                   "conv_im2col": lambda t, o=None: conv_im2col(t, w_flat, b, o)}
        errors = {}
        for name, conv in engines.items():
            errors[name] = relative_error(conv(xp), ref)
            print(f"max rel err {name} ({route}) vs library conv: {errors[name]:.2e}")
            if not errors[name] < LIBRARY_TOL:
                raise SystemExit(f"conv_probe: {name} does not match the library conv")
    result = {"shape": [B, H, W, C], "dtype": args.dtype, "errors": errors}
    if device.type != "cuda":
        return result

    # Timing: iters chained applications per engine, one CUDA graph each.
    # The kernels ping-pong between two padded buffers (zero borders),
    # writing each output straight into the next input's interior.
    flops = 2 * B * H * W * 9 * C * C
    bufs = [xp.clone(), torch.zeros_like(xp)]
    state = {"y": x, "k": 0}

    def library_step():
        state["y"] = library_conv(state["y"], w_lib, b[0])

    def kernel_step(conv):
        def step():
            k = state["k"]
            conv(bufs[k % 2], bufs[(k + 1) % 2])
            state["k"] = k + 1
        return step

    us = {}
    with torch.no_grad():
        us["library_conv"] = _chain_us(library_step, args.iters)
        for name, conv in engines.items():
            us[name] = _chain_us(kernel_step(conv), args.iters)
    for name, t in us.items():
        print(f"{name}: {t:7.2f} us/conv   {flops / (t * 1e-6) / 1e12:6.1f} TFLOP/s")
    result.update(us_per_conv=us, tflops={k: flops / (t * 1e-6) / 1e12 for k, t in us.items()})
    return result


if __name__ == "__main__":
    main()
