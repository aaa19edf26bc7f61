"""The port's ``LlamaLM`` / ``generate`` (``horovod_tpu_torch.models``)
held against the JAX package's, on the same weights.

The JAX model initialises the weights; they cross to the port through
``llama_from_flax`` as numpy arrays. Everything runs in float32 on the
CPU at ``LLAMA_TINY`` widths (the port's decode wrappers take their plain
versions there; the JAX side runs its Pallas decode kernel in interpret
mode). Also: import hygiene of the port — it loads no JAX module.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu.ops.attention import reference_attention as jax_reference
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.convert import llama_from_flax
from horovod_tpu_torch.ops import decode_attention as tops
from horovod_tpu_torch.ops.attention import reference_attention
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "horovod_tpu_torch")

JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                           max_seq_len=64)
TCFG = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32,
                           max_seq_len=64)
JMODEL = jllama.LlamaLM(JCFG)
# float32 on both sides: differences are summation order and libm only.
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    variables = JMODEL.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return variables, llama_from_flax(params, TCFG, device="cpu")


def _ids(seed, b, s):
    return np.random.RandomState(seed).randint(
        0, JCFG.vocab_size, (b, s)).astype(np.int32)


def test_full_forward_logits_match_jax(pair):
    variables, model = pair
    ids = _ids(0, 2, 12)
    want = np.asarray(JMODEL.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_prefill_logits_match_jax(pair):
    variables, model = pair
    ids = _ids(1, 2, 10)
    want, _ = JMODEL.apply(variables, jnp.asarray(ids),
                           cache=jllama.init_kv_cache(JCFG, 2, 32),
                           cache_index=0)
    cache = tllama.init_kv_cache(TCFG, 2, 32, device="cpu")
    with torch.no_grad():
        got, cache = model(torch.from_numpy(ids).long(), cache=cache,
                           cache_index=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # The prefill wrote the prompt's rows, and nothing past them.
    k0 = cache["layer_0"]["k"]
    assert bool((k0[:, :10] != 0).any()) and bool((k0[:, 10:] == 0).all())


DECODE_B, DECODE_S, DECODE_STEPS, DECODE_WINDOW = 2, 7, 6, 32


@pytest.fixture(scope="module")
def jax_decode_trace(pair):
    """JAX's greedy decode (its Pallas decode kernel, one jitted step):
    the prompt and, per step, the fed token and the step's logits."""
    variables, _ = pair
    ids = _ids(2, DECODE_B, DECODE_S)
    step = jax.jit(lambda v, t, c, i: JMODEL.apply(v, t, cache=c,
                                                   cache_index=i))
    cache = jllama.init_kv_cache(JCFG, DECODE_B, DECODE_WINDOW)
    logits, cache = JMODEL.apply(variables, jnp.asarray(ids), cache=cache,
                                 cache_index=0)
    trace = []
    for i in range(DECODE_STEPS):
        tok = np.array(jnp.argmax(logits[:, -1], axis=-1))
        logits, cache = step(variables, jnp.asarray(tok[:, None]), cache,
                             jnp.int32(DECODE_S + i))
        trace.append((tok, np.asarray(logits)))
    return ids, trace


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["kernel_path", "einsum_path"])
def test_decode_step_logits_match_jax_teacher_forced(pair, jax_decode_trace,
                                                     kernel):
    """Per-step decode logits, teacher-forced on JAX's own greedy tokens:
    the contiguous decode-kernel path (plain version on the CPU) and the
    ``decode_kernel_disabled()`` einsum path."""
    _, model = pair
    ids, trace = jax_decode_trace
    tcache = tllama.init_kv_cache(TCFG, DECODE_B, DECODE_WINDOW,
                                  device="cpu")
    ctx = (tllama.decode_kernel_disabled() if not kernel
           else tllama.decode_path_context("kernel"))
    with torch.no_grad(), ctx:
        _, tcache = model(torch.from_numpy(ids).long(), cache=tcache,
                          cache_index=0)
        for i, (tok, want) in enumerate(trace):
            got, tcache = model(torch.from_numpy(tok[:, None]).long(),
                                cache=tcache, cache_index=DECODE_S + i)
            np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_tokens_equal_jax(pair, seed):
    variables, model = pair
    ids = _ids(10 + seed, 2, 5 + 3 * seed)
    want = np.asarray(jllama.generate(JMODEL, variables, jnp.asarray(ids),
                                      max_new_tokens=10))
    tops.reset_launch_counts()
    got = tllama.generate(model, torch.from_numpy(ids), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tllama.LAST_DECODE_PATH.path == "kernel"
    assert tops.LAUNCHES["decode_attention"] == 0     # CPU: plain version
    with tllama.decode_kernel_disabled():
        got_einsum = tllama.generate(model, torch.from_numpy(ids),
                                     max_new_tokens=10)
    assert tllama.LAST_DECODE_PATH.path == "einsum"
    np.testing.assert_array_equal(got_einsum.numpy(), want)


def test_generate_validates_arguments(pair):
    _, model = pair
    ids = torch.zeros((1, 60), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds the cache window"):
        tllama.generate(model, ids, max_new_tokens=10)
    with pytest.raises(ValueError, match="Generator"):
        tllama.generate(model, ids[:, :4], max_new_tokens=2,
                        temperature=1.0)
    gen = torch.Generator().manual_seed(0)
    out = tllama.generate(model, ids[:, :4], max_new_tokens=3,
                          temperature=0.7, generator=gen)
    assert out.shape == (1, 7)
    assert torch.equal(tllama.generate(model, ids[:, :4], 0), ids[:, :4])


def test_init_kv_cache_rounds_like_jax():
    for max_len in (64, 1024, 1025, 2000):
        jshape = jllama.init_kv_cache(JCFG, 1, max_len)["layer_0"]["k"].shape
        tshape = tllama.init_kv_cache(TCFG, 1, max_len,
                                      device="cpu")["layer_0"]["k"].shape
        assert tuple(tshape) == tuple(jshape)


def test_rotary_and_reference_attention_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    pos = rng.randint(0, 100, (2, 5)).astype(np.int32)
    for p in (None, pos[0], pos):
        want = jllama.rotary_embedding(
            jnp.asarray(x), 10000.0, None if p is None else jnp.asarray(p))
        got = tllama.rotary_embedding(
            torch.from_numpy(x), 10000.0,
            None if p is None else torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    q = rng.randn(2, 3, 4, 16).astype(np.float32)
    k = rng.randn(2, 6, 2, 16).astype(np.float32)
    v = rng.randn(2, 6, 2, 16).astype(np.float32)
    mask = rng.rand(2, 6) > 0.3
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         key_mask=jnp.asarray(mask), causal=True)
    got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              key_mask=torch.from_numpy(mask), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_llama_from_flax_raises_on_missing_wrong_or_extra(pair):
    variables, _ = pair
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, params)
        fn(tree)
        return tree

    missing = edited(lambda t: t["layer_1"]["attention"]["wk"].pop(
        "kernel"))
    with pytest.raises(KeyError, match="layer_1/attention/wk/kernel"):
        llama_from_flax(missing, TCFG, device="cpu")
    wrong = edited(lambda t: t["final_norm"].update(
        scale=np.ones(TCFG.dim + 1, np.float32)))
    with pytest.raises(ValueError, match="final_norm/scale has shape"):
        llama_from_flax(wrong, TCFG, device="cpu")
    extra = edited(lambda t: t.update(layer_2=t["layer_1"]))
    with pytest.raises(ValueError, match="nothing maps"):
        llama_from_flax(extra, TCFG, device="cpu")


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None legitimately means it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.LlamaLM(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.init_kv_cache(TCFG, 1, 8)
    assert tllama.LlamaLM(TCFG, device="cpu").device.type == "cpu"


def test_port_imports_no_jax_or_reference_package():
    code = (
        "import sys\n"
        "import horovod_tpu_torch\n"
        "import horovod_tpu_torch.common.config\n"
        "import horovod_tpu_torch.common.hvd_logging\n"
        "import horovod_tpu_torch.common.topology\n"
        "import horovod_tpu_torch.common.basics\n"
        "import horovod_tpu_torch.torch\n"
        "import horovod_tpu_torch.torch.mpi_ops\n"
        "import horovod_tpu_torch.torch.compression\n"
        "import horovod_tpu_torch.examples.llama_training\n"
        "import horovod_tpu_torch.ops.attention\n"
        "import horovod_tpu_torch.ops.decode_attention\n"
        "import horovod_tpu_torch.models.llama\n"
        "import horovod_tpu_torch.models.convert\n"
        "import horovod_tpu_torch.models.layers\n"
        "import horovod_tpu_torch.models.resnet\n"
        "import horovod_tpu_torch.models.vgg\n"
        "import horovod_tpu_torch.models.inception\n"
        "import horovod_tpu_torch.models.mlp\n"
        "import horovod_tpu_torch.models.bert\n"
        "import horovod_tpu_torch.models.vit\n"
        "import horovod_tpu_torch.examples.synthetic_benchmark\n"
        "import horovod_tpu_torch.examples.bert_pretraining\n"
        "import horovod_tpu_torch.serving\n"
        "import horovod_tpu_torch.serving.router\n"
        "import horovod_tpu_torch.metrics\n"
        "import horovod_tpu_torch.metrics.registry\n"
        "import horovod_tpu_torch.trace\n"
        "import horovod_tpu_torch.examples.llama_generation\n"
        "import horovod_tpu_torch.examples.serving_loadgen\n"
        "import horovod_tpu_torch.parallel\n"
        "import horovod_tpu_torch.parallel.moe\n"
        "import horovod_tpu_torch.models.moe_lm\n"
        "import horovod_tpu_torch.examples.moe_lm_training\n"
        "import horovod_tpu_torch.examples.moe_training\n"
        "import horovod_tpu_torch.examples.vit_training\n"
        "import horovod_tpu_torch.examples.mnist\n"
        "import horovod_tpu_torch.parallel.mesh\n"
        "import horovod_tpu_torch.parallel.exchange\n"
        "import horovod_tpu_torch.parallel.hierarchical\n"
        "import horovod_tpu_torch.parallel.sequence\n"
        "import horovod_tpu_torch.parallel.pipeline\n"
        "import horovod_tpu_torch.examples.long_context_ring_attention\n"
        "import horovod_tpu_torch.examples.tp_decode_profile\n"
        "import horovod_tpu_torch.examples.pipeline_parallel\n"
        "import horovod_tpu_torch.torch.partition\n"
        "import horovod_tpu_torch.torch.zero\n"
        "import horovod_tpu_torch.torch.fsdp\n"
        "import horovod_tpu_torch.utils\n"
        "import horovod_tpu_torch.utils.checkpoint\n"
        "import horovod_tpu_torch.elastic\n"
        "import horovod_tpu_torch.examples.llama_fsdp_training\n"
        "import horovod_tpu_torch.examples.fsdp_hbm_budget\n"
        "import horovod_tpu_torch.examples.imagenet_resnet50\n"
        "import horovod_tpu_torch.common.message\n"
        "import horovod_tpu_torch.common.handles\n"
        "import horovod_tpu_torch.common.retry\n"
        "import horovod_tpu_torch.common.wire\n"
        "import horovod_tpu_torch.common.response_cache\n"
        "import horovod_tpu_torch.common.timeline\n"
        "import horovod_tpu_torch.common.reduction\n"
        "import horovod_tpu_torch.controller\n"
        "import horovod_tpu_torch.controller.service\n"
        "import horovod_tpu_torch.controller.controller\n"
        "import horovod_tpu_torch.controller.native\n"
        "import horovod_tpu_torch.core\n"
        "import horovod_tpu_torch.core.bindings\n"
        "import horovod_tpu_torch.run\n"
        "import horovod_tpu_torch.run.launch\n"
        "import horovod_tpu_torch.run.watchdog\n"
        "import horovod_tpu_torch.run.task_fn\n"
        "import horovod_tpu_torch.run.nic_discovery\n"
        "import horovod_tpu_torch.common.autotune\n"
        "import horovod_tpu_torch.controller.autotune_glue\n"
        "import horovod_tpu_torch.controller.bucket_scheduler\n"
        "import horovod_tpu_torch.utils.scaling_model\n"
        "import horovod_tpu_torch.trace.clock\n"
        "import horovod_tpu_torch.trace.merge\n"
        "import horovod_tpu_torch.trace.straggler\n"
        "import horovod_tpu_torch.examples.overlap_probe\n"
        "import horovod_tpu_torch.analysis\n"
        "import horovod_tpu_torch.analysis.autofix\n"
        "import horovod_tpu_torch.analysis.cpp\n"
        "import horovod_tpu_torch.tools.lint\n"
        "import horovod_tpu_torch.tools.protocheck\n"
        "import horovod_tpu_torch.tools.abicheck\n"
        "import horovod_tpu_torch.tools.check\n"
        "import horovod_tpu_torch.doctor\n"
        "import horovod_tpu_torch.metrics.exporter\n"
        "import horovod_tpu_torch.metrics.recorder\n"
        "import horovod_tpu_torch.utils.live_calibration\n"
        "import horovod_tpu_torch.tools.doctor\n"
        "import horovod_tpu_torch.common.profiler\n"
        "import horovod_tpu_torch.utils.comm_accounting\n"
        "import horovod_tpu_torch.utils.hlo_phases\n"
        "import horovod_tpu_torch.utils.overlap\n"
        "import horovod_tpu_torch.examples.bert_phase_profile\n"
        "import horovod_tpu_torch.examples.decode_phase_profile\n"
        "import horovod_tpu_torch.examples.moe_phase_profile\n"
        "import horovod_tpu_torch.examples.vit_phase_profile\n"
        "import horovod_tpu_torch.examples.comm_volume_report\n"
        "import horovod_tpu_torch.torch.optim\n"
        "import horovod_tpu_torch.examples.word2vec\n"
        "import horovod_tpu_torch.sim\n"
        "import horovod_tpu_torch.sim.measure\n"
        "import horovod_tpu_torch.tools.simcluster\n"
        "import horovod_tpu_torch.tools.capacity\n"
        "import horovod_tpu_torch.tools.straggler\n"
        "import horovod_tpu_torch.examples.simcluster_probe\n"
        "import horovod_tpu_torch.examples.capacity_probe\n"
        "import horovod_tpu_torch.utils.timing\n"
        "import horovod_tpu_torch.examples.flash_attention_benchmark\n"
        "import horovod_tpu_torch.examples.headpack_probe\n"
        "import horovod_tpu_torch.examples.decode_floor_probe\n"
        "import horovod_tpu_torch.examples.resnet50_roofline\n"
        "import horovod_tpu_torch.examples.allreduce_benchmark\n"
        "import horovod_tpu_torch.examples.wire_bandwidth_probe\n"
        "import horovod_tpu_torch.examples.scaling_efficiency\n"
        "import horovod_tpu_torch.examples.scaling_projection\n"
        "import horovod_tpu_torch.examples.autotune_efficacy\n"
        "import horovod_tpu_torch.spark\n"
        "import horovod_tpu_torch.spark.driver\n"
        "import horovod_tpu_torch.examples.mxnet_mnist\n"
        "import horovod_tpu_torch.examples.mxnet_imagenet_resnet50\n"
        "import horovod_tpu_torch.examples.spark_mnist\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'horovod_tpu'))\n"
        # ``import tensorflow`` loads jax by itself where jax is installed,
        # so the TF and Keras front ends and their examples are held by
        # the guard: no import of jax or the JAX package from the port.
        "sys.path.insert(0, 'tests')\n"
        "import torch_import_guard\n"
        "offenders = torch_import_guard.install('horovod_tpu_torch')\n"
        "import horovod_tpu_torch.tensorflow\n"
        "import horovod_tpu_torch.tensorflow.tf_ops\n"
        "import horovod_tpu_torch.tensorflow.keras\n"
        "import horovod_tpu_torch.keras\n"
        "import horovod_tpu_torch.keras.callbacks\n"
        + "".join(f"import horovod_tpu_torch.examples.{name}\n" for name in (
            "tensorflow_mnist", "tensorflow_mnist_eager",
            "tensorflow_keras_mnist", "tensorflow_synthetic_benchmark",
            "tensorflow_word2vec", "keras_mnist", "keras_mnist_advanced",
            "keras_imagenet_resnet50", "keras_spark_rossmann")) +
        "print(bad, offenders)\n"
        "sys.exit(1 if bad or offenders else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_name_jax_or_the_reference_package():
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, name) for name in sorted(files)
                  if name.endswith((".py", ".cu", ".cuh", ".cc", ".h"))]
    scanned = {os.path.relpath(p, PKG) for p in paths}
    # The parallel modes' files are among them.
    for name in ("parallel/mesh.py", "parallel/exchange.py",
                 "parallel/hierarchical.py", "parallel/sequence.py",
                 "parallel/pipeline.py",
                 "examples/long_context_ring_attention.py",
                 "examples/tp_decode_profile.py",
                 "examples/pipeline_parallel.py",
                 # The sharded-state slice's.
                 "torch/partition.py", "torch/zero.py", "torch/fsdp.py",
                 "utils/checkpoint.py", "elastic/__init__.py",
                 "examples/llama_fsdp_training.py",
                 "examples/fsdp_hbm_budget.py",
                 "examples/imagenet_resnet50.py",
                 # The eager-tier controller slice's.
                 "common/message.py", "common/handles.py",
                 "common/retry.py", "common/wire.py",
                 "common/response_cache.py", "common/timeline.py",
                 "common/reduction.py",
                 "controller/__init__.py", "controller/service.py",
                 "controller/controller.py", "run/__init__.py",
                 "run/__main__.py", "run/launch.py", "run/watchdog.py",
                 "run/task_fn.py", "run/nic_discovery.py",
                 # The native data plane's.
                 "core/__init__.py", "core/bindings.py",
                 "controller/native.py", "core/src/ring.cc",
                 "core/src/engine.cc", "core/src/shm.cc",
                 # The tuning and tracing loop's.
                 "common/autotune.py", "controller/autotune_glue.py",
                 "controller/bucket_scheduler.py", "utils/scaling_model.py",
                 "trace/clock.py", "trace/merge.py", "trace/straggler.py",
                 "examples/overlap_probe.py",
                 # The protocol monitor, lock-order checks, static gates.
                 "analysis/__init__.py", "analysis/framework.py",
                 "analysis/dataflow.py", "analysis/rules.py",
                 "analysis/autofix.py", "analysis/lockorder.py",
                 "analysis/protocol.py", "analysis/cpp.py",
                 "tools/lint.py", "tools/protocheck.py",
                 "tools/abicheck.py", "tools/check.py",
                 # The cluster doctor's.
                 "doctor/__init__.py", "doctor/evidence.py",
                 "doctor/rules.py", "metrics/exporter.py",
                 "metrics/recorder.py", "utils/live_calibration.py",
                 "tools/doctor.py",
                 # The profiler and the trace readers'.
                 "common/profiler.py", "utils/comm_accounting.py",
                 "utils/hlo_phases.py", "utils/overlap.py",
                 "examples/bert_phase_profile.py",
                 "examples/decode_phase_profile.py",
                 "examples/moe_phase_profile.py",
                 "examples/vit_phase_profile.py",
                 "examples/comm_volume_report.py",
                 # The optimizer, flag and example gaps; the simulated
                 # cluster and its tools.
                 "torch/optim.py", "examples/word2vec.py",
                 "sim/__init__.py", "sim/cluster.py", "sim/worker.py",
                 "sim/faults.py", "sim/scenario.py", "sim/measure.py",
                 "tools/simcluster.py", "tools/capacity.py",
                 "tools/straggler.py", "examples/simcluster_probe.py",
                 "examples/capacity_probe.py",
                 # The probes, the MXNet and Spark front ends.
                 "utils/timing.py", "examples/flash_attention_benchmark.py",
                 "examples/headpack_probe.py",
                 "examples/decode_floor_probe.py",
                 "examples/resnet50_roofline.py",
                 "examples/allreduce_benchmark.py",
                 "examples/wire_bandwidth_probe.py",
                 "examples/scaling_efficiency.py",
                 "examples/scaling_projection.py",
                 "examples/autotune_efficacy.py", "mxnet/__init__.py",
                 "mxnet/mpi_ops.py", "spark/__init__.py", "spark/driver.py",
                 "examples/mxnet_mnist.py",
                 "examples/mxnet_imagenet_resnet50.py",
                 "examples/spark_mnist.py",
                 # The TensorFlow and Keras front ends.
                 "tensorflow/__init__.py", "tensorflow/compression.py",
                 "tensorflow/tf_ops.py", "tensorflow/src/tf_ops.cc",
                 "tensorflow/keras/__init__.py", "keras/__init__.py",
                 "keras/callbacks.py", "examples/tensorflow_mnist.py",
                 "examples/tensorflow_mnist_eager.py",
                 "examples/tensorflow_keras_mnist.py",
                 "examples/tensorflow_synthetic_benchmark.py",
                 "examples/tensorflow_word2vec.py", "examples/keras_mnist.py",
                 "examples/keras_mnist_advanced.py",
                 "examples/keras_imagenet_resnet50.py",
                 "examples/keras_spark_rossmann.py"):
        assert name in scanned, name
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for needle in ("import jax", "from jax", "import flax",
                       "import optax", "import orbax", "horovod_tpu.",
                       "import fake_", "from fake_"):
            if needle in text:
                offenders.append(f"{os.path.relpath(path, REPO)}: "
                                 f"{needle!r}")
    assert not offenders, offenders
