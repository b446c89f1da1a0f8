"""Profiling helpers: device traces, op annotations, operation counts and
the roofline.

The port of polar_codes_tpu/utils/profiling.py. A trace is a
torch.profiler run exported as a Chrome trace; `cost_analysis` counts
with torch.utils.flop_counter.FlopCounterMode, which sees the matmuls and
convolutions of the torch ops a function dispatches and nothing inside a
hand-written kernel, so `roofline` takes the analytic counts of
utils/costmodel.py wherever the model's class has a formula.

The roofs are the published peaks of one card, keyed by its name as
torch.cuda.get_device_name gives it; a card that is not in the table, and
the CPU, get no peak, no `mfu` and no `hbm_util`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable, Optional

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# card name: (operations per second, device-memory bytes per second). The
# decoders' f/g/min/add arithmetic is scalar, so the operations roof is the
# float32 rate outside the tensor cores. Published at a 700 W power limit.
PEAKS = {"NVIDIA H100 80GB HBM3": (SCALAR_OPS_PER_S, HBM_BYTES_PER_S)}


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Profile the block with torch.profiler (CPU, and CUDA where there is a
    card) and write <log_dir>/trace.json, a Chrome trace (Perfetto,
    chrome://tracing). log_dir defaults to polar_trace in the temporary
    directory.

        with device_trace("tr"):
            dec.decode(llr)
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "polar_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


def cost_analysis(fn: Callable, *args) -> dict:
    """Run fn(*args) once under FlopCounterMode and return {"flops": n};
    {} when it counts nothing, as for every hand-written kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return {"flops": float(flops)} if flops else {}


def device_peak(device=None):
    """(operations/s, bytes/s) of the device, or None: a CUDA device whose
    name PEAKS lists has one; another card and the CPU have none. device
    None is the current card where there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return PEAKS.get(torch.cuda.get_device_name(dev))


def derive_roofline(flops: float, nbytes: float, seconds: Optional[float] = None,
                    device=None) -> dict:
    """Achieved/peak ratios from given operation and byte counts."""
    out = {"flops": flops, "bytes_accessed": nbytes}
    if nbytes > 0:
        out["arithmetic_intensity"] = flops / nbytes
    peak = device_peak(device)
    if peak and nbytes > 0:
        ridge = peak[0] / peak[1]
        out["bound"] = "compute" if out["arithmetic_intensity"] >= ridge else "memory"
    if seconds and seconds > 0:
        out["achieved_flops_per_s"] = flops / seconds
        out["achieved_bytes_per_s"] = nbytes / seconds
        if peak:
            out["mfu"] = flops / seconds / peak[0]
            out["hbm_util"] = nbytes / seconds / peak[1]
            # well under both roofs, the call is bound by neither: by its
            # chains of dependent operations and its launches
            if out["mfu"] < 0.5 and out["hbm_util"] < 0.5:
                out["bound"] = "dataflow"
    return out


def roofline(fn: Callable, *args, seconds: Optional[float] = None, model=None,
             batch: Optional[int] = None) -> dict:
    """Operation and byte counts of one call of fn(*args), with achieved
    rates, `mfu`, `hbm_util` and the verdict when `seconds` (a measured
    time per call, e.g. from utils.timing.time_device_fn) is given.

    With `model` (a decoder or encoder) and `batch`, the analytic count of
    utils/costmodel.py takes over wherever the model's class has a formula
    (cost_model "analytic"): every route of the port runs a hand-written
    kernel that the flop counter cannot see. Otherwise fn runs once under
    the flop counter (cost_model "flop_counter"); a formula that raises is
    recorded as cost_model_fallback_reason. The peaks are those of the
    model's device, else of the first tensor argument's.
    """
    analytic, fallback_reason = None, None
    if model is not None and batch:
        try:
            analytic = analytic_costs(model, batch)
        except Exception as exc:  # a formula's fault: record it, do not hide it
            fallback_reason = f"{type(exc).__name__}: {exc}"
    if analytic is not None:
        flops, nbytes, source = analytic["flops"], analytic["bytes_accessed"], "analytic"
    else:
        flops = cost_analysis(fn, *args).get("flops", 0.0)
        nbytes, source = 0.0, "flop_counter"
    device = getattr(model, "device", None)
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)), "cpu")
    out = derive_roofline(flops, nbytes, seconds, device)
    out["cost_model"] = source
    if fallback_reason is not None:
        out["cost_model_fallback_reason"] = fallback_reason
    return out


def analytic_costs(model, batch: int) -> Optional[dict]:
    """The per-family count of utils/costmodel.py by the model's class name;
    None where the class has no formula. A formula's error propagates."""
    from . import costmodel

    name = type(model).__name__
    if name == "SCLDecoder":
        return costmodel.scl_costs(model, batch)
    if name == "FastSSCDecoder":
        return costmodel.fastssc_costs(model, batch)
    if name == "PolarEncoder":
        return costmodel.encode_costs(model, batch)
    if name in ("ScanDecoder", "FastSScanDecoder"):
        return costmodel.scan_costs(model, batch)
    if name in ("LargeSCDecoder", "LargeSCLDecoder"):
        return costmodel.large_costs(model, batch)
    return None
