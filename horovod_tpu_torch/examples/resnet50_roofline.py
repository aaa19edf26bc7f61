"""ResNet-50 per-op roofline accounting on the card — the port's
counterpart of ``examples/resnet50_roofline.py``.

Captures a ``torch.profiler`` trace (``hvd.profiler.trace``, shapes
recorded) of the train step ``examples/imagenet_resnet50.py`` runs
(ResNet-50 with bf16 activations, float32 parameters and BatchNorm
statistics, SGD with momentum 0.9, batch 128 at 224²), then scores every
op against the two-resource roofline
``t_ideal = max(flops / peak, bytes / HBM bandwidth)``:

* an op is the outermost ``aten::`` call on the stack that launched a
  kernel (``utils/hlo_phases.Timeline``); its measured time is the sum
  of the device time of every kernel, copy and fill it launched;
* flops and bytes come from the op's recorded input shapes, strides and
  dtypes (:func:`op_cost`): convolutions and their backward,
  products, BatchNorm and its backward, elementwise and reduction ops,
  and the optimizer's ``_foreach`` ops. Bytes count each input read once
  (a broadcast dimension, stride 0, once) and each output written once:
  a lower bound on what the op must move. An op with no tensor input
  (a fill) or none of these forms counts 0 and stays in the measured
  total;
* the peaks are the H100 SXM5's datasheet figures (dense bf16 for bf16
  products, TF32 for float32 ones, the HBM3 bandwidth;
  ``utils/timing``);
* up to the L2's 50 MB (:data:`L2_BYTES`) of an op's bytes may come from
  or stay in the L2 (a tensor its producer just wrote): only the bytes
  beyond it must cross HBM, and the L2's own bandwidth is no datasheet
  figure, so those count as free. An op whose whole footprint fits the
  L2 is bound by its flops alone. ``t_hbm_all_ms`` is every byte over
  HBM, for comparison.

The aggregate ``sum(t_ideal) / sum(t_measured)`` says how close the step
runs to the card's ceiling; the per-op rows (grouped by op and shapes)
name where the rest goes. An op row that scores over 1.05 of its ideal
would run faster than the card can: its count is wrong, and the probe
fails.

    python -m horovod_tpu_torch.examples.resnet50_roofline [--out PATH]
    python -m horovod_tpu_torch.examples.resnet50_roofline --trace PATH

``--trace`` parses an existing trace in place of capturing one. The
last line is the summary JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.utils.comm_accounting import _TYPE_BYTES
from horovod_tpu_torch.utils.hlo_phases import Timeline
from horovod_tpu_torch.utils.timing import (H100_SXM_BF16_FLOPS,
                                            H100_SXM_HBM_BYTES_PER_S,
                                            H100_SXM_TF32_FLOPS)

TRACE_STEPS = 5
MAX_RATIO = 1.05
#: The H100's L2 cache (datasheet: 50 MB).
L2_BYTES = 50 << 20

CONV = ("aten::conv2d", "aten::convolution", "aten::_convolution")
MATMUL = ("aten::linear", "aten::mm", "aten::addmm", "aten::matmul",
          "aten::bmm", "aten::baddbmm")
BATCH_NORM = ("aten::batch_norm", "aten::native_batch_norm",
              "aten::_batch_norm_impl_index", "aten::cudnn_batch_norm",
              "aten::_native_batch_norm_legit",
              "aten::_native_batch_norm_legit_functional")
BATCH_NORM_BWD = ("aten::native_batch_norm_backward",
                  "aten::cudnn_batch_norm_backward",
                  "aten::batch_norm_backward")
# Ops whose output has the broadcast shape of their tensor inputs, at
# least as wide as the widest of them.
ELEMENTWISE = {
    "aten::add", "aten::sub", "aten::mul", "aten::div", "aten::relu",
    "aten::clamp_min", "aten::clamp", "aten::threshold_backward",
    "aten::neg", "aten::exp", "aten::log", "aten::sqrt", "aten::rsqrt",
    "aten::pow", "aten::where", "aten::maximum", "aten::minimum",
    "aten::addcmul", "aten::addcdiv", "aten::lerp", "aten::sigmoid",
    "aten::tanh", "aten::silu", "aten::gelu", "aten::abs", "aten::sign",
}
# Element types of two bytes as kernel names spell them.
NARROW_TYPES = ("BFloat16", "bfloat16", "Half", "__half")
# In-place ops that write their first argument without reading it.
WRITE_ONLY = {"aten::fill_", "aten::zero_", "aten::normal_",
              "aten::uniform_", "aten::random_", "aten::copy_"}


# ---------------------------------------------------------------------------
# The cost model


def _itemsize(type_name: str) -> int:
    return _TYPE_BYTES.get(type_name, 0)


def _unique_numel(dims, strides) -> int:
    """Elements an input really holds: a dimension of stride 0 (a
    broadcast, an ``expand``) counts once."""
    n = 1
    for i, size in enumerate(dims):
        if strides and i < len(strides) and strides[i] == 0:
            continue
        n *= size
    return n


def _tensors(args: dict, list_itemsize: int = 4) -> List[Tuple[list, list,
                                                             int]]:
    """The op's tensor inputs as (dims, strides, itemsize), lists of
    tensors (the ``_foreach`` ops) flattened. The trace records no
    element type for a list: ``list_itemsize`` stands for it."""
    dims = args.get("Input Dims") or []
    strides = args.get("Input Strides") or []
    types = args.get("Input type") or []
    out = []
    for i, d in enumerate(dims):
        t = types[i] if i < len(types) else ""
        s = strides[i] if i < len(strides) else []
        if t == "TensorList" or (d and isinstance(d[0], list)):
            elem = _itemsize(t) or list_itemsize
            for j, sub in enumerate(d):
                sub_s = s[j] if isinstance(s, list) and j < len(s) \
                    and isinstance(s[j], list) else []
                out.append((sub, sub_s, elem))
        elif _itemsize(t):
            out.append((d, s, _itemsize(t)))
    return out


def _bytes(tensors) -> int:
    return sum(_unique_numel(d, s) * size for d, s, size in tensors)


def _concrete(args: dict, i: int):
    """The ``i``-th concrete (non-tensor) argument parsed, or None."""
    vals = args.get("Concrete Inputs") or []
    if i >= len(vals) or vals[i] in ("", None):
        return None
    try:
        return json.loads(vals[i].replace("True", "true")
                          .replace("False", "false"))
    except ValueError:
        return None


def _pair(v, default):
    if v is None:
        return default
    if isinstance(v, list):
        return tuple(v) if len(v) == 2 else (v[0], v[0])
    return (v, v)


def _conv_geometry(x, w, stride, padding, dilation, groups):
    """(output dims, MACs, input elements the windows touch) of a 2-D
    convolution: x (N, C, H, W), w (Cout, C/g, kh, kw). A window narrower
    than its stride (a strided 1x1) skips input rows and columns."""
    n, c, h, wd = x
    cout, cin_g, kh, kw = w
    sh, sw = _pair(stride, (1, 1))
    ph, pw = _pair(padding, (0, 0))
    dh, dw = _pair(dilation, (1, 1))
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (wd + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    rows = h if dh * (kh - 1) + 1 >= sh else min(h, ho * kh)
    cols = wd if dw * (kw - 1) + 1 >= sw else min(wd, wo * kw)
    return ([n, cout, ho, wo], n * cout * ho * wo * cin_g * kh * kw,
            n * c * rows * cols)


def _peak(itemsize: int) -> float:
    """The fastest a product of this element width can run: bf16 (and
    narrower) on the bf16 tensor cores, float32 as TF32."""
    return H100_SXM_BF16_FLOPS if itemsize <= 2 else H100_SXM_TF32_FLOPS


def op_cost(name: str, args: dict,
            list_itemsize: int = 4) -> Tuple[float, float, str]:
    """(flops, bytes, kind) an op must do and move, from its recorded
    inputs; kind is the cost model's name (``none`` counts 0)."""
    ts = _tensors(args, list_itemsize)
    if not ts:
        return 0.0, 0.0, "none"
    if name in CONV and len(ts) >= 2 and len(ts[0][0]) == 4:
        x, w = ts[0], ts[1]
        # conv2d (x, w, b, stride, padding, dilation, groups); the others
        # carry the same first five.
        groups = _concrete(args, 8 if name in ("aten::convolution",
                                               "aten::_convolution")
                           else 6)
        out, macs, touched = _conv_geometry(
            x[0], w[0], _concrete(args, 3), _concrete(args, 4),
            _concrete(args, 5), groups or 1)
        nbytes = (touched * x[2] + _bytes(ts[1:])
                  + math.prod(out) * x[2])
        return 2.0 * macs, float(nbytes), "conv"
    if name == "aten::convolution_backward" and len(ts) >= 3:
        go, x, w = ts[0], ts[1], ts[2]
        mask = _concrete(args, 10) or [True, True, False]
        _, macs, touched = _conv_geometry(
            x[0], w[0], _concrete(args, 4), _concrete(args, 5),
            _concrete(args, 6), _concrete(args, 9) or 1)
        nbytes = _bytes([go])
        flops = 0.0
        if mask[0]:                       # grad_input: read w, write dx
            nbytes += _bytes([w]) + _bytes([x])
            flops += 2.0 * macs
        if len(mask) > 1 and mask[1]:     # grad_weight: read x, write dw
            nbytes += touched * x[2] + _bytes([w])
            flops += 2.0 * macs
        return flops, float(nbytes), "conv"
    if name in MATMUL and len(ts) >= 2:
        if name in ("aten::addmm", "aten::baddbmm"):
            a, b = ts[1], ts[2] if len(ts) > 2 else ts[1]
        else:
            a, b = ts[0], ts[1]
        ad, bd = a[0], b[0]
        if name == "aten::linear":        # weight (out, in)
            m, k, n = math.prod(ad[:-1]), ad[-1], bd[0]
        elif len(ad) == 3 and len(bd) == 3:
            m, k, n = ad[0] * ad[1], ad[2], bd[2]
        else:
            m, k, n = math.prod(ad[:-1]), ad[-1], bd[-1]
        nbytes = _bytes(ts) + m * n * a[2]
        return 2.0 * m * k * n, float(nbytes), "matmul"
    if name in BATCH_NORM:
        x = ts[0]
        # read x once, write the normalised output once.
        return 0.0, float(_bytes(ts) + _bytes([x])), "batch_norm"
    if name in BATCH_NORM_BWD and len(ts) >= 2:
        go, x = ts[0], ts[1]
        return 0.0, float(_bytes(ts) + _bytes([x])), "batch_norm"
    if name.startswith("aten::_foreach_"):
        nbytes = _bytes(ts)
        if name.endswith("_"):            # the first list is written back
            first = len(_flat_first_list(args))
            nbytes += _bytes(ts[:first])
        return 0.0, float(nbytes), "optimizer"
    nbytes = _bytes(ts)
    if name in WRITE_ONLY:
        # the first argument written (copy_ also reads its source).
        return 0.0, float(nbytes), "elementwise"
    if name.endswith("_") and not name.endswith("__"):
        # in place: the first input read and written back.
        return 0.0, float(nbytes + _bytes(ts[:1])), "elementwise"
    if name in ELEMENTWISE:
        shape = _broadcast([d for d, _, _ in ts])
        # A 0-dim tensor takes no part in the result's type.
        widths = [size for d, _, size in ts if d] or [ts[0][2]]
        out = math.prod(shape) * max(widths)
        return 0.0, float(nbytes + out), "elementwise"
    return 0.0, float(nbytes), "other"


def _flat_first_list(args: dict) -> list:
    dims = (args.get("Input Dims") or [[]])[0]
    return dims if dims and isinstance(dims[0], list) else [dims]


def _broadcast(shapes: List[list]) -> list:
    rank = max((len(s) for s in shapes), default=0)
    out = [1] * rank
    for s in shapes:
        for i, size in enumerate(s):
            j = rank - len(s) + i
            out[j] = max(out[j], size)
    return out


def ideal_s(flops: float, nbytes: float, itemsize: int) -> Tuple[float,
                                                                  float]:
    """(flop time, HBM time) at the card's peaks: the bytes beyond the
    L2's capacity over the HBM bandwidth."""
    return (flops / _peak(itemsize) if flops else 0.0,
            max(0.0, nbytes - L2_BYTES) / H100_SXM_HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# Reading the trace


def _scored_op(tl: Timeline, i: int) -> Optional[int]:
    """The outermost ``aten::`` op on the stack that launched device
    event ``i`` (None: no op, e.g. a launch outside any op)."""
    for j in tl.device_stack(i):
        if tl.name(j).startswith("aten::"):
            return j
    return None


def _signature(args: dict) -> str:
    return json.dumps([d for d in (args.get("Input Dims") or []) if d])


def roofline(trace, steps: int, max_ratio: float = MAX_RATIO) -> dict:
    """Score ``trace`` (a path, parsed JSON or a :class:`Timeline`) of
    ``steps`` steps. Rows group op instances by (name, input shapes)."""
    tl = trace if isinstance(trace, Timeline) else Timeline(trace)
    measured: Dict[int, float] = {}
    narrow: Dict[int, bool] = {}
    unattributed_us = 0.0
    for i in tl.device:
        us = float(tl.events[i].get("dur", 0.0))
        op = _scored_op(tl, i)
        if op is None:
            unattributed_us += us
        else:
            measured[op] = measured.get(op, 0.0) + us
            # A list's element type shows only in its kernels' names.
            narrow[op] = narrow.get(op, False) or any(
                t in tl.name(i) for t in NARROW_TYPES)
    rows: Dict[tuple, dict] = {}
    for op, us in sorted(measured.items()):
        name = tl.name(op)
        args = tl.events[op].get("args", {})
        list_itemsize = 2 if narrow[op] else 4
        flops, nbytes, kind = op_cost(name, args, list_itemsize)
        ts = _tensors(args, list_itemsize)
        itemsize = ts[0][2] if ts else 4
        t_fl, t_mem = ideal_s(flops, nbytes, itemsize)
        key = (name, _signature(args))
        row = rows.setdefault(key, {
            "op": name, "shapes": key[1], "kind": kind, "count": 0,
            "t_measured_ms": 0.0, "t_flops_ms": 0.0, "t_hbm_ms": 0.0,
            "t_hbm_all_ms": 0.0, "flops": 0.0, "bytes": 0.0})
        row["count"] += 1
        row["t_measured_ms"] += us / 1e3
        row["t_flops_ms"] += t_fl * 1e3
        row["t_hbm_ms"] += t_mem * 1e3
        row["t_hbm_all_ms"] += nbytes / H100_SXM_HBM_BYTES_PER_S * 1e3
        row["flops"] += flops
        row["bytes"] += nbytes
    tot_meas = unattributed_us / 1e3
    tot_roof = tot_sum = tot_all = 0.0
    for _, row in sorted(rows.items()):
        roof = max(row["t_flops_ms"], row["t_hbm_ms"])
        row["t_ideal_ms"] = roof
        row["roofline_ratio"] = (roof / row["t_measured_ms"]
                                 if row["t_measured_ms"] else None)
        row["limiter"] = ("flops" if row["t_flops_ms"] > row["t_hbm_ms"]
                          else "hbm")
        tot_meas += row["t_measured_ms"]
        tot_roof += roof
        tot_sum += row["t_flops_ms"] + row["t_hbm_ms"]
        tot_all += max(row["t_flops_ms"], row["t_hbm_all_ms"])
    ordered = sorted(rows.values(), key=lambda r: -r["t_measured_ms"])
    over = [r for r in ordered if r["roofline_ratio"] is not None
            and r["roofline_ratio"] > max_ratio]
    by_kind: Dict[str, dict] = {}
    for r in ordered:
        k = by_kind.setdefault(r["kind"], {"measured_ms": 0.0,
                                           "ideal_ms": 0.0, "ops": 0})
        k["measured_ms"] += r["t_measured_ms"] / steps
        k["ideal_ms"] += r["t_ideal_ms"] / steps
        k["ops"] += r["count"]
    worst = sorted((r for r in ordered if r["t_ideal_ms"] > 0),
                   key=lambda r: r["t_measured_ms"] - r["t_ideal_ms"],
                   reverse=True)
    return {
        "steps_in_window": steps,
        "measured_ms_per_step": tot_meas / steps,
        "max_bound_ms_per_step": tot_roof / steps,
        "max_bound_ratio": tot_roof / tot_meas if tot_meas else None,
        "sum_bound_ms_per_step": tot_sum / steps,
        "sum_bound_ratio": tot_sum / tot_meas if tot_meas else None,
        "max_bound_ratio_all_bytes_hbm": (tot_all / tot_meas if tot_meas
                                          else None),
        "unattributed_ms_per_step": unattributed_us / 1e3 / steps,
        "by_kind": by_kind,
        "ops_over_max_ratio": len(over),
        "over_max_ratio": over[:10],
        "top_ops": ordered[:25],
        "worst_ops": [{"op": r["op"], "shapes": r["shapes"][:120],
                       "count": r["count"],
                       "t_measured_ms": r["t_measured_ms"],
                       "t_ideal_ms": r["t_ideal_ms"],
                       "roofline_ratio": r["roofline_ratio"],
                       "gap_ms_per_step": (r["t_measured_ms"]
                                           - r["t_ideal_ms"]) / steps}
                      for r in worst[:5]],
    }


# ---------------------------------------------------------------------------
# Capturing a trace


def capture_trace(batch: int, trace_dir: str, steps: int,
                  device: str = "cuda", image_size: int = 224,
                  warmup: int = 3) -> Tuple[str, float]:
    """One trace of ``steps`` train steps of the ImageNet example's
    recipe after ``warmup`` steps; returns (path, img/s during the
    capture)."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.imagenet_resnet50 import (
        NUM_CLASSES, synthetic_batch)
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.utils.timing import probe_device, sync

    dev = probe_device(device)
    hvd.init(device=None if dev.type == "cuda" else "cpu")
    dev = hvd.device()
    model = ResNet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16,
                     device=dev, seed=0)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    x, y = synthetic_batch(0, batch, image_size, dev)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x, train=True), y)
        loss.backward()
        optimizer.step()
        return loss

    for _ in range(warmup):
        step()
    sync(dev)
    t0 = time.perf_counter()
    with hvd.profiler.trace(trace_dir) as path:
        for _ in range(steps):
            loss = step()
        float(loss.detach())
    wall = time.perf_counter() - t0
    return path, batch * steps / wall


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=TRACE_STEPS,
                    help="traced steps")
    ap.add_argument("--trace", default=None,
                    help="parse this trace in place of capturing one")
    ap.add_argument("--trace-dir", default=None,
                    help="where a captured trace goes (default a "
                    "temporary directory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    capture_img_s = None
    if args.trace:
        path = args.trace
        label = "trace file"
    else:
        from horovod_tpu_torch.utils.timing import device_label, probe_device

        label = device_label(probe_device(args.device))
        trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="rn50-trace-")
        path, capture_img_s = capture_trace(args.batch, trace_dir,
                                            args.steps, args.device)
    result = roofline(path, args.steps)
    out = {
        "what": ("per-op two-resource roofline of the ImageNet example's "
                 "ResNet-50 train step: t_ideal = max(flops / peak, bytes "
                 "/ HBM bandwidth) per aten op, from its recorded shapes"),
        "batch": args.batch,
        "device": label, "trace": path,
        "capture_img_s": capture_img_s,
        "peaks": {"hbm_bytes_per_s": H100_SXM_HBM_BYTES_PER_S,
                  "bf16_flops": H100_SXM_BF16_FLOPS,
                  "tf32_flops": H100_SXM_TF32_FLOPS,
                  "l2_bytes": L2_BYTES,
                  "source": "NVIDIA H100 SXM5 datasheet (dense)"},
        "roofline": result,
    }
    for row in result["worst_ops"]:
        print(json.dumps({"metric": "roofline_op", **row}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    summary = {"metric": "resnet50_roofline_ratio",
               "value": result["max_bound_ratio"],
               "sum_bound_ratio": result["sum_bound_ratio"],
               "measured_ms_per_step": result["measured_ms_per_step"],
               "ops_over_max_ratio": result["ops_over_max_ratio"],
               "device": label, "out": args.out}
    print(json.dumps(summary), flush=True)
    if result["ops_over_max_ratio"]:
        raise SystemExit(
            f"{result['ops_over_max_ratio']} op row(s) ran faster than "
            f"{MAX_RATIO}x their ideal time: the cost model is wrong "
            f"there: {json.dumps(result['over_max_ratio'][:3])[:2000]}")
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
