"""What every cell shares: the files it is found by, the program's model, the
device trace's reduction, and the no-JAX guard.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<file>.json``) and a traffic mix (``traffic/<name>.json``); the
traffic file's ``kind`` names the code that drives it (``kinds/<kind>.py``),
and each per-layer metric is read by ``metrics/<name>.py`` (or the reader of
its name up to the first dot), which declares the module ranges it needs
(``RANGES``). All four are found by name, so a later cell, mix or metric is a
new file and a new entry.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vface_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file, whatever its name holds (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_plugin_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class CellSpec:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def find_cell(workload: str, root: Path = ROOT) -> CellSpec:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r} (have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    listed = lambda m: workload in m.get("workloads", [workload])
    return CellSpec(
        root=root, name=workload, chips=cell["chips"], config=load_json(root / configs[cell["config"]]["file"]),
        traffic=load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)])


def kind_module(traffic: dict, root: Path = ROOT):
    return load_module(root / "benchmark" / "kinds" / f"{traffic['kind']}.py")


def metric_path(name: str, root: Path = ROOT) -> Path:
    """``metrics/<name>.py``, else the reader shared by every metric of the name
    up to its first dot (``mfu.video`` and ``mfu.image``: ``metrics/mfu.py``)."""
    metrics = root / "benchmark" / "metrics"
    own = metrics / f"{name}.py"
    return own if own.is_file() else metrics / f"{name.split('.')[0]}.py"


def metric_module(name: str, root: Path = ROOT):
    return load_module(metric_path(name, root))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------ the program
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _sizes(group: dict, drop=()) -> dict:
    out = {}
    for k, v in group.items():
        if k in drop:
            continue
        if k == "dtype":
            v = _DTYPES[v]
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        out[k] = v
    return out


def program_config(cfg: dict):
    """The program's own SD-v1 preset (its routing options) with every size and
    dtype of the configuration file."""
    from vface_torch.models.ldm import ModelConfig

    preset = ModelConfig.sd_v1_inpaint()
    cond = cfg["cond"]
    return dataclasses.replace(
        preset,
        unet=dataclasses.replace(preset.unet, **_sizes(cfg["unet"])),
        vae=dataclasses.replace(preset.vae, **_sizes(cfg["vae"])),
        cond=dataclasses.replace(preset.cond, clip=dataclasses.replace(preset.cond.clip, **_sizes(cond["clip"])),
                                 **_sizes(cond, drop=("clip",))),
        scale_factor=cfg["scale_factor"], timesteps=cfg["timesteps"], linear_start=cfg["linear_start"],
        linear_end=cfg["linear_end"], image_size=cfg["image_size"])


def seeded_weights(cfg: dict, seed: int, device):
    """({"unet", "vae", "cond"}, {"bisenet", "raft", "landmark"}) state dicts from the seed."""
    from benchmark import weights
    from benchmark.reference.bisenet import BiSeNet
    from benchmark.reference.conditioning import Conditioner
    from benchmark.reference.config import model_config
    from benchmark.reference.raft import RAFT
    from benchmark.reference.unet import UNetModel
    from benchmark.reference.vae import AutoencoderKL

    mc = model_config(cfg)
    with torch.device("meta"):
        parts = {"unet": UNetModel(mc.unet), "vae": AutoencoderKL(mc.vae), "cond": Conditioner(mc.cond),
                 "bisenet": BiSeNet(), "raft": RAFT()}
    state = weights.seeded_state_dicts(parts, seed, device)
    aux = {"bisenet": state.pop("bisenet"), "raft": state.pop("raft"),
           "landmark": weights.landmark_state_dict(device)}
    return state, aux


def program_model(cfg: dict, state: dict, device):
    """The program's model with the conditioner, holding ``state``."""
    from vface_torch.models.ldm import VFaceModel

    model = VFaceModel(program_config(cfg), device=device, conditioner=True)
    model.load_params(state)
    return model.eval()


def reference_model(cfg: dict, state: dict, device):
    from benchmark.reference.config import model_config
    from benchmark.reference.ldm import VFaceModel

    model = VFaceModel(model_config(cfg), device)
    model.load_params(state)
    return model.eval()


def float32_as_stated() -> None:
    """float32 products in float32: the configurations state float32 for the
    conditioner and the aux nets, and PyTorch's default lets cuDNN run float32
    convolutions in TF32 (which moved the aligned crops by 1e-2 on some clips)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_check() -> dict:
    """The check that float32 products run in float32, read as the window opens
    and again as it closes: 1 where cuBLAS or cuDNN may run them in TF32,
    limit 0."""
    on = torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    return {"float32_in_tf32": {"value": int(on), "limit": 0}}


def verdict(checks: dict) -> bool:
    """``correct``: every compared number within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float64), want.to(torch.float64)
    return float((got - want).norm() / want.norm())


# -------------------------------------------------------------- the trace
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the range marks on the device's timeline


class Ranges:
    """Module calls marked on the device's timeline: each hooked call launches a
    marker kernel as it starts and another as it ends, and is listed, with its
    input's shape, in the order it ran. The kernels between a pair of markers
    are that call's. With no range added, nothing is hooked."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.order, self.shapes, self._handles = [], {}, []

    def add(self, name: str, modules) -> None:
        self.shapes[name] = []
        for m in modules:
            self._handles.append(m.register_forward_pre_hook(lambda mod, args, n=name: self._enter(n, args)))
            self._handles.append(m.register_forward_hook(lambda mod, args, out: self._mark()))

    def _mark(self) -> None:
        if self.cuda:
            torch.cuda._sleep(1)

    def _enter(self, name: str, args) -> None:
        self.order.append(name)
        self.shapes[name].append(tuple(args[0].shape))
        self._mark()

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:160]


class Trace:
    """One profiled call's device timeline (kernels, copies, sets) reduced:
    busy seconds, seconds by kernel, the device seconds of each marked range,
    and the idle gaps by the kernel the host launched next."""

    def __init__(self, events, window_s: float, ranges: Ranges):
        dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                     if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation())
        marks = [d for d in dev if MARKER in d[2]]
        self.device = [d for d in dev if MARKER not in d[2]]
        self.window_s = window_s
        busy = _union((s, e) for s, e, _ in dev)
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.ranges_ok = len(marks) == 2 * len(ranges.order)
        self.range_s = {}
        if self.ranges_ok:
            starts = [marks[2 * k][0] for k in range(len(ranges.order))]
            for s, e, _ in self.device:
                k = bisect.bisect_right(starts, s) - 1
                if k >= 0 and s < marks[2 * k + 1][0]:
                    name = ranges.order[k]
                    self.range_s[name] = self.range_s.get(name, 0.0) + (e - s) / 1e9
        self._gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        self._next = [s for s, _, _ in dev]
        self._names = [d[2] for d in dev]
        self._span_s = (busy[-1][1] - busy[0][0]) / 1e9 if busy else 0.0

    def device_seconds_in(self, range_name: str) -> float:
        """Seconds of the device work launched inside the marked range ``range_name``."""
        return self.range_s.get(range_name, 0.0)

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for s, e, name in self.device:
            by[short_name(name)] = by.get(short_name(name), 0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds by the kernel that ended each gap (the host was
        preparing its launch), and the host's time before the first kernel and
        after the last."""
        by = {"(host, before the first kernel or after the last)": max(0.0, self.window_s - self._span_s)}
        for gs, ge in self._gaps:
            name = "before " + short_name(self._names[bisect.bisect_left(self._next, ge)])
            by[name] = by.get(name, 0.0) + (ge - gs) / 1e9
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
