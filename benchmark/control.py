"""The control: the reference in the program's place, one precision below the
configuration's, which every cell's check has to fail.

The configuration states bf16 for the UNet and the VAE; the control runs the
reference with every convolution and dense product of those two in fp8
(e4m3: the activations scaled per tensor, the weights per output channel,
into e4m3's range, rounded, and multiplied in float32), the conditioner and
the aux nets in float32 as stated. It goes through the cell's own check
(``Cell.check`` with ``control=``), so it reads the same numbers on the
inputs of the call, window or pair that a run with that seed and that many
calls checks, and is judged by the same limits.

    python3 benchmark/control.py --workload NAME --calls N --seeds N [N ...]

prints one JSON line a seed, with ``correct`` as a run would give it. Not
part of a benchmark run.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference.layers import Conv, Dense  # noqa: E402

E4M3_MAX = 448.0


def fp8(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x rounded to e4m3 after scaling its absolute maximum (over ``dims``, or
    the whole tensor) to e4m3's largest value, and scaled back, in float32."""
    x = x.to(torch.float32)
    amax = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    scale = E4M3_MAX / amax.clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _conv(self, x):
    w = fp8(self.weight, dims=tuple(range(1, self.weight.ndim)))
    return F.conv2d(fp8(x), w, self.bias, self.stride, self.padding, self.dilation)


def _dense(self, x):
    return F.linear(fp8(x), fp8(self.weight, dims=(1,)), self.bias)


@contextlib.contextmanager
def fp8_products(*modules):
    """Every Conv and Dense under ``modules`` computes in fp8 while inside."""
    patched = []
    for root in modules:
        for m in root.modules():
            if isinstance(m, (Conv, Dense)):
                m.forward = (_conv if isinstance(m, Conv) else _dense).__get__(m)
                patched.append(m)
    try:
        yield
    finally:
        for m in patched:
            del m.forward


def fp8_control(model):
    """The control's precision over the reference's model."""
    return fp8_products(model.unet, model.vae)


def control_checks(spec, seed: int, device, calls: int) -> dict:
    """The cell's checks with the control in the program's place, on the inputs a
    run with ``seed`` and ``calls`` calls checks."""
    cell = harness.kind_module(spec.traffic, spec.root).Cell(spec.config, spec.traffic, seed, device)
    return cell.check([None] * calls, seed, control=fp8_control)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True, help="the calls of the run whose check is read")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = harness.find_cell(args.workload)
    harness.float32_as_stated()
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_checks(spec, seed, "cuda", args.calls)
        line = {"workload": args.workload, "seed": seed, "calls": args.calls, "correct": harness.verdict(checks),
                "checks": checks, "seconds": time.perf_counter() - t0, "device": torch.cuda.get_device_name()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
