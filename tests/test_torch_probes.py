"""The port's probe examples (``horovod_tpu_torch/examples``) at smoke size
on the CPU, against the JAX package's where both run here.

* ``flash_attention_benchmark --device cpu --plain`` (and the kernels'
  CPU path) prints the JAX probe's keys; ``flash_attention(block_q=,
  block_k=)`` takes the compiled tile and refuses any other, and the
  tile table matches ``csrc/flash_attention.cu``'s constants;
* ``generate(unroll=k)``, k in {1, 2, 4}, gives the JAX package's
  ``generate(..., unroll=k)`` tokens on weights carried across by
  ``llama_from_flax`` (LLAMA_TINY widths, 2 layers, float32), greedy;
  sampled, the port's tokens are equal across k from one generator seed,
  as the JAX package's are across k from one key (the two packages'
  generators differ, so sampled tokens are not compared across them);
* the roofline scorer on a hand-written trace with known flops and
  bytes, and its cost model over a recorded CPU trace of the ResNet-50
  step;
* ``decode_floor_probe`` and ``headpack_probe`` at smoke size.

The probes that launch jobs (the wire probe, the projection, scaling
efficiency, autotune efficacy, the allreduce benchmark) are in
``test_torch_probes_launched.py``.

Tolerances: tokens exactly; the roofline's flops and bytes exactly, its
times to 1e-9 relative.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import (decode_floor_probe,
                                        flash_attention_benchmark,
                                        headpack_probe, resnet50_roofline)
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.convert import llama_from_flax
from horovod_tpu_torch.ops import attention as flash_ops
from horovod_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FLASH_KEYS = {"B", "S", "H", "D", "block_q", "block_k", "fwd_ms",
                  "train_ms", "metric"}


def _last_json(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# Flash attention: the benchmark, the tile arguments, the tile table


@pytest.mark.parametrize("extra", [["--plain"], ["--sweep"]],
                         ids=["plain", "kernels_cpu_path_sweep"])
def test_flash_benchmark_rows_carry_the_jax_keys(extra, capsys):
    records = flash_attention_benchmark.main(
        ["--device", "cpu", "--batch", "1", "--seq-len", "64", "--heads",
         "4", "--kv-heads", "2", "--iters", "1"] + extra)
    out = capsys.readouterr().out
    assert len(records) == 1
    rec = records[0]
    assert JAX_FLASH_KEYS <= set(rec), rec
    assert (rec["block_q"], rec["block_k"]) == (192, 128)
    assert rec["fwd_ms"] > 0 and rec["train_ms"] > 0
    assert rec["metric"] == ("plain_attn_fwd_ms" if "--plain" in extra
                             else "flash_fwd_ms")
    summary = _last_json(out)
    assert summary["metric"] == "flash_attention_benchmark"
    assert summary["best_fwd_ms"] == rec["fwd_ms"]


def test_flash_attention_takes_the_compiled_tile_and_refuses_others():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 40, 4, 64).astype(np.float32))
               for _ in range(3))
    base = flash_ops.flash_attention(q, k, v, causal=True)
    tiled = flash_ops.flash_attention(q, k, v, causal=True, block_q=64,
                                      block_k=32)
    assert torch.equal(base, tiled)
    with pytest.raises(ValueError, match=r"compiled \(block_q, block_k\) "
                       r"pairs: .*bfloat16 D64: \(192, 128\)"):
        flash_ops.flash_attention(q, k, v, block_q=512, block_k=1024)
    with pytest.raises(ValueError, match="block_q=64, block_k=None"):
        flash_ops.flash_attention(q, k, v, block_q=64)
    with pytest.raises(ValueError, match="not a tile"):
        flash_attention_benchmark.main(
            ["--device", "cpu", "--batch", "1", "--seq-len", "16",
             "--block-q", "128", "--block-k", "128", "--iters", "1"])


def _cu_tiles():
    """(dtype, width) -> {kernel: (rows, keys)} from the CUDA source's
    tile structs and FMA instantiations."""
    src = open(os.path.join(REPO, "horovod_tpu_torch", "csrc",
                            "flash_attention.cu")).read()

    def struct(name, d):
        body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
        env = {"D": d}
        for key in ("kWgs", "kRows", "kKeys"):
            expr = re.search(r"%s = ([^;]+);" % key, body).group(1)
            expr = re.sub(r"(\w+ == \d+) \? (\d+) : (\d+)",
                          r"(\2 if \1 else \3)", expr)
            env[key] = eval(expr, {}, dict(env))  # noqa: S307 (test)
        return env["kRows"], env["kKeys"]

    geo = re.search(r"struct Geo \{(.*?)\n\};", src, re.S).group(1)
    assert "R = 16 * W;" in geo and "BN = 32;" in geo
    out = {}
    for d in (64, 128):
        out[("bfloat16", d)] = {"forward": struct("FwdTiles", d),
                                "backward_dq": struct("DqTiles", d),
                                "backward_dkdv": struct("DkdvTiles", d)}
    for m in re.finditer(r"if \(d == (\d+)\) return launch_fma<"
                         r"(float|__nv_bfloat16), \d+, (\d+)>", src):
        d, t, w = int(m.group(1)), m.group(2), int(m.group(3))
        rows = 16 * w
        out[("float32" if t == "float" else "bfloat16", d)] = {
            "forward": (rows, 32), "backward_dq": (rows, 32),
            "backward_dkdv": (32, rows)}
    return out


def test_tile_table_matches_the_cuda_source():
    assert _cu_tiles() == flash_ops.FLASH_TILES


# ---------------------------------------------------------------------------
# generate(unroll=k) against the JAX package

JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                           max_seq_len=64)
TCFG = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32,
                           max_seq_len=64)
JMODEL = jllama.LlamaLM(JCFG)


@pytest.fixture(scope="module")
def pair():
    variables = JMODEL.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return variables, llama_from_flax(params, TCFG, device="cpu")


def _prompt(seed=3, b=2, s=6):
    return np.random.RandomState(seed).randint(
        0, JCFG.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_generate_unroll_greedy_equals_jax(pair, unroll):
    variables, model = pair
    ids = _prompt()
    want = np.asarray(jllama.generate(JMODEL, variables, jnp.asarray(ids),
                                      max_new_tokens=9, unroll=unroll))
    got = tllama.generate(model, torch.from_numpy(ids), max_new_tokens=9,
                          unroll=unroll)
    np.testing.assert_array_equal(got.numpy(), want)
    base = tllama.generate(model, torch.from_numpy(ids), max_new_tokens=9)
    assert torch.equal(got, base)


def test_generate_unroll_sampled_equal_across_unroll(pair):
    variables, model = pair
    ids = _prompt(5)
    ported = [tllama.generate(model, torch.from_numpy(ids), 9,
                              temperature=0.8,
                              generator=torch.Generator().manual_seed(7),
                              unroll=k) for k in (1, 2, 4)]
    for out in ported[1:]:
        assert torch.equal(out, ported[0])
    theirs = [np.asarray(jllama.generate(
        JMODEL, variables, jnp.asarray(ids), max_new_tokens=9,
        temperature=0.8, rng=jax.random.PRNGKey(7), unroll=k))
        for k in (1, 2, 4)]
    for out in theirs[1:]:
        np.testing.assert_array_equal(out, theirs[0])
    with pytest.raises(ValueError, match="unroll"):
        tllama.generate(model, torch.from_numpy(ids), 4, unroll=0)


def test_decode_floor_probe_on_the_cpu(capsys):
    rec = decode_floor_probe.main(
        ["--device", "cpu", "--model", "tiny",
         "--batch-size", "2", "--prompt-len", "8", "--max-new-tokens", "9",
         "--unrolls", "1,2", "--reps", "1"])
    assert rec["tokens_equal"]
    assert set(rec["decode_tok_s"]) == {"unroll1", "unroll2"}
    assert rec["empty_loop"]["iters"] == 8
    assert "graph_ms_total" not in rec["empty_loop"]   # no card
    assert rec["roofline_tok_s"] > 0
    assert _last_json(capsys.readouterr().out)["tokens_equal"]


def test_probes_refuse_to_run_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        timing.probe_device("cuda")
    assert timing.probe_device("cpu").type == "cpu"


def test_headpack_probe_parts_on_the_cpu(capsys):
    out = headpack_probe.main(["--device", "cpu", "--parts", "CE",
                               "--iters", "1"])
    parts = [r["part"] for r in out["rows"]]
    assert parts == ["C_flash_qk", "C_flash_qk", "E_sumdiff_pack",
                     "E_sumdiff_pack"]
    assert all(r["ms"] > 0 and "tfs" in r for r in out["rows"])
    assert _last_json(capsys.readouterr().out)["metric"] == "headpack_probe"


# ---------------------------------------------------------------------------
# The roofline scorer


def _op(name, ts, dur, dims, types, strides=None, concrete=None):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": {
                "Input Dims": dims, "Input type": types,
                "Input Strides": strides or [[] for _ in dims],
                "Concrete Inputs": concrete or ["" for _ in dims]}}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 1, "tid": 1, "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _hand_trace():
    bf, f32 = "c10::BFloat16", "float"
    ev = [
        # conv2d: x (2, 3, 8, 8), w (4, 3, 3, 3), stride 2, padding 1.
        _op("aten::conv2d", 0, 50, [[2, 3, 8, 8], [4, 3, 3, 3], [], [], [],
                                    [], []],
            [bf, bf, "", "ScalarList", "ScalarList", "ScalarList",
             "Scalar"], concrete=["", "", "", "[2, 2]", "[1, 1]", "[1, 1]",
                                  "1"]),
        _launch(10, 1), _launch(20, 2),
        _kernel("conv_fprop", 100, 4, 1), _kernel("nchwToNhwc", 105, 1, 2),
        # add with a broadcast operand: (16, 32) + (1, 32) expanded.
        _op("aten::add", 60, 10, [[16, 32], [16, 32]], [f32, f32],
            [[32, 1], [0, 1]]),
        _launch(62, 3), _kernel("elementwise_add", 110, 2, 3),
        # in place: read both, write the first.
        _op("aten::add_", 80, 10, [[1000], [1000], []], [f32, f32,
                                                          "Scalar"]),
        _launch(82, 4), _kernel("elementwise_add_", 113, 1, 4),
        # the optimizer's list op over two float32 tensors.
        _op("aten::_foreach_mul_", 95, 4, [[[10, 10], [5]], []],
            ["TensorList", "Scalar"], [[[10, 1], [1]], []]),
        _launch(96, 5), _kernel("multi_tensor_apply_kernel<float>", 115,
                                1, 5),
        # copy_: read the source, write the destination.
        _op("aten::copy_", 120, 4, [[64], [64], []], [bf, f32, "Scalar"]),
        _launch(121, 6), _kernel("copy_kernel", 125, 1, 6),
        # a kernel no op launched.
        _kernel("stray", 130, 3, 99),
        # a strided 1x1 convolution reads a quarter of its input; 400 MB
        # of traffic, past the L2's 50 MB.
        _op("aten::conv2d", 140, 50, [[128, 256, 56, 56], [512, 256, 1, 1],
                                      [], [], [], [], []],
            [bf, bf, "", "ScalarList", "ScalarList", "ScalarList",
             "Scalar"], concrete=["", "", "", "[2, 2]", "[0, 0]", "[1, 1]",
                                  "1"]),
        _launch(141, 7), _kernel("conv_1x1", 200, 90, 7),
    ]
    return ev


def test_roofline_scores_a_hand_written_trace():
    res = resnet50_roofline.roofline(_hand_trace(), steps=1)
    rows = {r["op"]: r for r in res["top_ops"]
            if not r["shapes"].startswith("[[128")} | {
        "strided": next(r for r in res["top_ops"]
                        if r["shapes"].startswith("[[128"))}
    macs = 2 * 4 * 4 * 4 * 3 * 3 * 3      # N Cout Ho Wo Cin kh kw
    conv = rows["aten::conv2d"]
    assert conv["flops"] == 2 * macs
    assert conv["bytes"] == (2 * 3 * 64 + 4 * 27 + 2 * 4 * 16) * 2
    assert conv["t_measured_ms"] == pytest.approx(5e-3)
    assert conv["kind"] == "conv" and conv["count"] == 1
    t_fl = 2 * macs / timing.H100_SXM_BF16_FLOPS
    # Its bytes fit the L2: the flops bound it.
    assert conv["t_hbm_ms"] == 0.0
    assert conv["t_hbm_all_ms"] == pytest.approx(
        conv["bytes"] / timing.H100_SXM_HBM_BYTES_PER_S * 1e3, rel=1e-9)
    assert conv["t_ideal_ms"] == pytest.approx(t_fl * 1e3, rel=1e-9)
    strided = rows["strided"]
    x_read = 128 * 256 * 28 * 28 * 2        # every other row and column
    out = 128 * 512 * 28 * 28 * 2
    assert strided["bytes"] == x_read + 512 * 256 * 2 + out
    assert strided["flops"] == 2 * 128 * 512 * 28 * 28 * 256
    t_hbm = (strided["bytes"] - resnet50_roofline.L2_BYTES) \
        / timing.H100_SXM_HBM_BYTES_PER_S
    assert strided["t_ideal_ms"] == pytest.approx(t_hbm * 1e3, rel=1e-9)
    assert strided["limiter"] == "hbm"
    assert rows["aten::add"]["bytes"] == (16 * 32 + 32 + 16 * 32) * 4
    assert rows["aten::add_"]["bytes"] == 3 * 1000 * 4
    assert rows["aten::_foreach_mul_"]["bytes"] == 2 * 105 * 4
    assert rows["aten::copy_"]["bytes"] == 64 * 2 + 64 * 4
    assert res["unattributed_ms_per_step"] == pytest.approx(3e-3)
    assert res["measured_ms_per_step"] == pytest.approx(103e-3)
    ideal = sum(r["t_ideal_ms"] for r in res["top_ops"])
    assert res["max_bound_ratio"] == pytest.approx(ideal / 103e-3,
                                                   rel=1e-9)
    assert 0 < res["max_bound_ratio"] <= 1
    assert res["ops_over_max_ratio"] == 0
    # An op measured faster than its ideal is a wrong count: flagged.
    fast = _hand_trace()
    for ev in fast:
        if ev.get("name") == "conv_1x1":
            ev["dur"] = 20
    over = resnet50_roofline.roofline(fast, steps=1)
    assert over["ops_over_max_ratio"] == 1
    assert over["over_max_ratio"][0]["op"] == "aten::conv2d"


def test_roofline_cost_model_over_a_recorded_resnet_step(tmp_path):
    from horovod_tpu_torch.utils.hlo_phases import Timeline

    try:
        path, _ = resnet50_roofline.capture_trace(2, str(tmp_path), 1,
                                                  "cpu", 32, warmup=1)
    finally:
        hvd.shutdown()
    tl = Timeline(path)
    kinds = {}
    for i, ev in enumerate(tl.events):
        if ev.get("cat") != "cpu_op" or not ev["name"].startswith("aten::"):
            continue
        if any(tl.name(j).startswith("aten::") for j in tl.parents[i]):
            continue
        flops, nbytes, kind = resnet50_roofline.op_cost(ev["name"],
                                                        ev["args"])
        kinds.setdefault(kind, set()).add(ev["name"])
        if kind == "conv":
            assert flops > 0 and nbytes > 0, ev["name"]
    assert {"aten::conv2d", "aten::convolution_backward"} <= kinds["conv"]
    assert {"aten::native_batch_norm",
            "aten::native_batch_norm_backward"} <= kinds["batch_norm"]
    assert "aten::linear" in kinds["matmul"]
