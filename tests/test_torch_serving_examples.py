"""The port's serving examples on the CPU: the load generator
(``horovod_tpu_torch/examples/serving_loadgen.py``) and the generation
example (``horovod_tpu_torch/examples/llama_generation.py``), the ports
of ``examples/serving_loadgen.py`` and ``examples/jax_llama_generation.py``
behind the JAX package's decode and serving bench rows.

The JAX load generator is loaded from its file with ``importlib``: its
top level imports only the standard library, so ``build_trace`` is
reachable without building a JAX engine.
"""

import ast
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from horovod_tpu_torch import metrics
from horovod_tpu_torch.examples import llama_generation
from horovod_tpu_torch.examples import serving_loadgen as loadgen
from horovod_tpu_torch.models import llama as tllama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOADGEN = os.path.join(REPO, "examples", "serving_loadgen.py")


def _jax_loadgen():
    spec = importlib.util.spec_from_file_location("jax_serving_loadgen",
                                                  JAX_LOADGEN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_record_keys():
    """The keys of the ``record`` dict the JAX example's ``main`` prints,
    read from its source."""
    with open(JAX_LOADGEN) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record dict in the JAX load generator")


@pytest.mark.parametrize("seed", [0, 9, 11])
@pytest.mark.parametrize("share", [0, 4], ids=["unique", "prefix_share"])
def test_build_trace_equals_the_jax_example(seed, share):
    kwargs = dict(seed=seed, requests=40, rate=30.0, min_prompt=20,
                  max_prompt=60, min_new=4, max_new=32, vocab_size=512,
                  prefix_share=share, prefix_len=16)
    want = _jax_loadgen().build_trace(**kwargs)
    got = loadgen.build_trace(**kwargs)
    assert len(got) == len(want) == 40
    for (ta, pa, na), (tb, pb, nb) in zip(got, want):
        assert ta == tb and na == nb
        assert pa.dtype == pb.dtype and np.array_equal(pa, pb)


def test_loadgen_fleet_with_a_kill_on_the_cpu(capsys):
    try:
        record = loadgen.main([
            "--model", "tiny", "--requests", "12", "--seed", "11",
            "--rate", "0", "--prefix-share", "2", "--prefix-len", "32",
            "--min-prompt", "40", "--max-prompt", "56", "--min-new", "4",
            "--max-new", "8", "--max-seq-len", "128", "--replicas", "2",
            "--chaos-kill", "--device", "cpu"])
    finally:
        metrics.reset_for_tests()
    assert record["failed"] == 0 and record["rejected"] == 0
    assert record["finished"] == 12
    assert set(record) == _jax_record_keys()
    assert record["substrate"] == "cpu"
    assert record["path"] == "kernel"
    # The doctor's summary over the measured run, the JAX record's field:
    # one departure is the fleet working as designed, not flapping.
    from horovod_tpu import doctor as jdoctor

    assert set(record["health"]) == set(jdoctor.summary({"findings": []}))
    assert record["health"]["findings"] >= len(
        record["health"]["rules_hit"])
    assert "router_replica_flapping" not in record["health"]["rules_hit"]
    assert record["killed_replica"] is not None
    assert record["router"]["departures"] == 1
    assert record["router"]["requests"] >= 12
    assert record["baseline_no_sharing"]["blocks_peak"] > 0
    assert record["warm_requests"] + record["cold_requests"] == 12
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith('{"metric": "serving_loadgen"')


def test_loadgen_refuses_a_kill_without_a_fleet():
    with pytest.raises(SystemExit):
        loadgen.parse_args(["--chaos-kill"])


def test_generation_example_runs_on_the_cpu(capsys):
    result = llama_generation.main([
        "--model", "tiny", "--prompt-len", "12", "--max-new-tokens", "6",
        "--batch-size", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    # The JAX bench rows read the rate with this regex.
    assert re.search(r"(\d+) decode tokens/sec", line), line
    assert line.startswith("llama-tiny prompt=12 b=2: ")
    out = result["out"]
    assert tuple(out.shape) == (2, 18) and result["tokens"] == 12
    # The same prompt and weights through generate() give the same ids.
    model = tllama.LlamaLM(tllama.LLAMA_TINY, device="cpu", seed=0)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, tllama.LLAMA_TINY.vocab_size, (2, 12)))
    assert torch.equal(out, tllama.generate(model, prompt, 6))
