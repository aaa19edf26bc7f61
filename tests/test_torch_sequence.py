"""The port's sequence parallelism (``horovod_tpu_torch.parallel.sequence``
and ``models.llama.sp_causal_lm_loss``) held against the JAX package.

One 4-rank and one 2-rank gloo job on the CPU run every case of the
port; each test runs the JAX counterpart under ``jax.shard_map`` on as
many CPU devices, with the same seeded numpy inputs, and compares. The
JAX flash inner path runs as its own tests run it (Pallas interpret
mode); the port's runs the kernels' plain versions, as a CPU tensor
does. Cases mirror ``tests/test_attention.py`` (ring: contiguous and
zigzag, causal and not, key mask with a shard whose keys are all
masked, GQA, flash forced on at a small S, gradients through the ring;
Ulysses and its head checks) and ``tests/test_llama.py`` (the
sequence-parallel loss, and Llama-tiny run sequence-parallel against the
unsharded model, gradients included). Everything is float32 within atol
2e-5 + rtol 1e-4 (the port's TOL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from horovod_tpu.parallel import make_mesh
from horovod_tpu.parallel import sequence as jseq
from horovod_tpu_torch.parallel import sequence as tseq

from torch_gloo import WORKER_HEAD, run_job
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-5, rtol=1e-4)
B, S, D = 2, 32, 8

WORKER = WORKER_HEAD + '''
import dataclasses

import torch.distributed as dist

from horovod_tpu_torch.models.convert import llama_from_flax, llama_to_flax
from horovod_tpu_torch.models.llama import LLAMA_TINY, sp_causal_lm_loss
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.parallel.sequence import (ring_attention,
                                                 ulysses_attention,
                                                 zigzag_positions,
                                                 zigzag_shard)


def main():
    hvd.init(device="cpu")
    arrays, specs = load_cases()
    mesh = make_mesh({"seq": hvd.size()})
    group, r, n = mesh.group("seq"), mesh.axis_index("seq"), hvd.size()
    res = {}

    def t(key):
        return torch.from_numpy(arrays[key])

    for spec in specs:
        name, kind = spec["name"], spec["kind"]
        zig = spec.get("layout") == "zigzag"

        def local(x):
            if zig:
                x = zigzag_shard(x, n)
            return x.chunk(n, dim=1)[r].contiguous()

        if kind in ("ring", "ulysses"):
            # Without gradients the ring streams its hops (one block
            # live); with them it rotates as one autograd node.
            q, k, v = (local(t(f"{name}/{x}")).requires_grad_(
                bool(spec.get("grad"))) for x in "qkv")
            if kind == "ring":
                mask = (local(t(f"{name}/mask")) if f"{name}/mask" in arrays
                        else None)
                out = ring_attention(
                    q, k, v, group, causal=spec["causal"], key_mask=mask,
                    layout=spec.get("layout", "contiguous"),
                    use_flash=spec.get("flash", "auto"))
            else:
                out = ulysses_attention(q, k, v, group,
                                        causal=spec["causal"])
            res[f"{name}/out"] = out
            if spec.get("grad"):
                (out ** 2).sum().backward()
                for x, leaf in zip("qkv", (q, k, v)):
                    res[f"{name}/d{x}"] = leaf.grad
        elif kind == "errors":
            for i, (hq, hk, hv) in enumerate(spec["heads"]):
                qkv = [torch.zeros(1, 8, h, 8) for h in (hq, hk, hv)]
                try:
                    ulysses_attention(*qkv, group)
                    res[f"{name}/{i}"] = np.array("no error")
                except ValueError as exc:
                    res[f"{name}/{i}"] = np.array(str(exc))
        elif kind == "sp_loss":
            logits = local(t(f"{name}/logits")).requires_grad_()
            ids = local(t(f"{name}/ids"))
            loss = sp_causal_lm_loss(logits, ids, group)
            loss.backward()
            res[f"{name}/loss"] = loss
            res[f"{name}/dlogits"] = logits.grad
        elif kind == "llama":
            cfg = dataclasses.replace(LLAMA_TINY, dtype=torch.float32)
            layout = spec.get("layout", "contiguous")
            if spec["attention"] == "ring":
                def fn(q, k, v, m):
                    return ring_attention(q, k, v, group, causal=True,
                                          layout=layout,
                                          use_flash=spec.get("flash",
                                                             "auto"))
                # The ring takes grouped K/V; Ulysses over 4 ranks needs
                # the K/V heads repeated to 4 first (the model does it).
                fn.supports_gqa = True
            else:
                def fn(q, k, v, m):
                    return ulysses_attention(q, k, v, group, causal=True)
            model = llama_from_flax(tree_of(arrays, f"{name}/params/"), cfg,
                                    device="cpu", attention_fn=fn,
                                    param_dtype=torch.float32)
            ids = local(t(f"{name}/ids")).long()
            s_local = ids.shape[1]
            pos = (zigzag_positions(r, s_local, n) if zig
                   else r * s_local + torch.arange(s_local))
            logits = model(ids, positions=pos)
            res[f"{name}/logits"] = logits
            if spec.get("grad"):
                sp_causal_lm_loss(logits, ids, group).backward()
                for key, g in flatten(llama_to_flax(model, grads=True)):
                    g = torch.from_numpy(g)
                    dist.all_reduce(g, group=group)   # the sum over seq
                    res[f"{name}/grad/{key}"] = g
        else:
            raise ValueError(kind)
    save(res)
    hvd.shutdown()
    print("worker ok")


if __name__ == "__main__":
    main()
'''


def _qkv(seed, h=4, hkv=4, s=S):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, s, h, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, s, hkv, D) * 0.3).astype(np.float32)
    v = (rng.randn(B, s, hkv, D) * 0.3).astype(np.float32)
    return q, k, v


def _mask(seed, world, s=S, empty_shard=0):
    """A random key mask, with every key of shard ``empty_shard`` masked
    (contiguous layout) in both sequences."""
    mask = np.random.RandomState(seed).rand(B, s) > 0.3
    s_local = s // world
    mask[:, empty_shard * s_local:(empty_shard + 1) * s_local] = False
    return mask


def _llama_params():
    import dataclasses

    from horovod_tpu.models.llama import LLAMA_TINY, LlamaLM

    cfg = dataclasses.replace(LLAMA_TINY, dtype=jnp.float32)
    ids = np.random.RandomState(31).randint(0, cfg.vocab_size, (2, S))
    model = LlamaLM(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    return model, params, ids


def _flat(tree, prefix=""):
    out = {}
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            out.update(_flat(value, prefix + key + "/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


# Case name -> spec: the 4-rank job runs RING, ULYSSES and LLAMA, the
# 2-rank job RING2 and ULYSSES2.
RING = {
    "contig": dict(causal=False),
    "contig_causal": dict(causal=True),
    "zigzag": dict(causal=False, layout="zigzag"),
    "zigzag_causal": dict(causal=True, layout="zigzag"),
    "mask": dict(causal=False, mask=True),
    "mask_causal": dict(causal=True, mask=True),
    "mask_flash": dict(causal=False, mask=True, flash=True),
    "mask_flash_zigzag_causal": dict(causal=True, mask=True, flash=True,
                                     layout="zigzag"),
    "gqa_causal": dict(causal=True, hkv=2),
    "gqa_zigzag_causal": dict(causal=True, hkv=2, layout="zigzag"),
    "flash": dict(causal=False, flash=True),
    "flash_causal": dict(causal=True, flash=True),
    "flash_zigzag": dict(causal=False, flash=True, layout="zigzag"),
    "flash_zigzag_causal": dict(causal=True, flash=True, layout="zigzag"),
    "grad_causal": dict(causal=True, grad=True),
    "grad_zigzag_causal": dict(causal=True, layout="zigzag", grad=True),
    "grad_flash_causal": dict(causal=True, flash=True, grad=True),
    "grad_flash_zigzag_causal": dict(causal=True, flash=True,
                                     layout="zigzag", grad=True),
    "grad_flash_mask": dict(causal=False, flash=True, mask=True,
                            grad=True),
    "grad_gqa_flash_causal": dict(causal=True, flash=True, hkv=2,
                                  grad=True),
    "grad_gqa_flash_zigzag_causal": dict(causal=True, flash=True, hkv=2,
                                         layout="zigzag", grad=True),
}
RING2 = {"w2_gqa_flash_causal": dict(causal=True, flash=True, hkv=2,
                                     grad=True),
         "w2_zigzag_mask_causal": dict(causal=True, mask=True,
                                       layout="zigzag", grad=True)}
ULYSSES = {"ulysses": dict(causal=False), "ulysses_causal":
           dict(causal=True, grad=True)}
ULYSSES2 = {"w2_ulysses_gqa": dict(causal=True, hkv=2, grad=True)}
LLAMA = {"llama_ring": dict(attention="ring", grad=True),
         "llama_ring_flash": dict(attention="ring", flash=True, grad=True),
         "llama_ring_zigzag": dict(attention="ring", layout="zigzag"),
         "llama_ulysses": dict(attention="ulysses")}
HEAD_ERRORS = [(2, 2, 2), (4, 2, 2), (8, 8, 4)]


def _build(world):
    inputs, specs = {}, []
    ring = RING if world == 4 else RING2
    ulysses = ULYSSES if world == 4 else ULYSSES2
    for i, (name, c) in enumerate(sorted(ring.items())):
        q, k, v = _qkv(100 + i, hkv=c.get("hkv", 4))
        inputs.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v})
        if c.get("mask"):
            inputs[f"{name}/mask"] = _mask(200 + i, world)
        specs.append(dict(name=name, kind="ring", **{
            key: c[key] for key in ("causal", "layout", "flash", "grad")
            if key in c}))
    for i, (name, c) in enumerate(sorted(ulysses.items())):
        q, k, v = _qkv(300 + i, hkv=c.get("hkv", 4))
        inputs.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v})
        specs.append(dict(name=name, kind="ulysses", causal=c["causal"],
                          grad=c.get("grad", False)))
    if world == 4:
        specs.append(dict(name="errors", kind="errors", heads=HEAD_ERRORS))
        rng = np.random.RandomState(7)
        inputs["sp_loss/logits"] = rng.randn(B, S, 50).astype(np.float32)
        inputs["sp_loss/ids"] = rng.randint(0, 50, (B, S))
        specs.append(dict(name="sp_loss", kind="sp_loss"))
        _, params, ids = _llama_params()
        for name, c in sorted(LLAMA.items()):
            inputs[f"{name}/ids"] = ids
            inputs.update({f"{name}/params/{k}": a
                           for k, a in sorted(_flat(params).items())})
            specs.append(dict(name=name, kind="llama", **c))
    return inputs, specs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both gloo jobs, run once: world -> per-rank outputs."""
    out = {}
    for world in (4, 2):
        inputs, specs = _build(world)
        out[world] = run_job(tmp_path_factory.mktemp(f"seq{world}"), world,
                             WORKER, inputs, specs)
    return out


def _gathered(ranks, key):
    """The ranks' shards of ``key`` concatenated along the sequence."""
    return np.concatenate([r[key] for r in ranks], axis=1)


def _mesh(world):
    return make_mesh({"seq": world}, devices=jax.devices()[:world])


def _jax_ring(world, c, q, k, v, mask):
    layout = c.get("layout", "contiguous")
    if layout == "zigzag":
        q, k, v = (jseq.zigzag_shard(jnp.asarray(x), world)
                   for x in (q, k, v))
        if mask is not None:
            mask = jseq.zigzag_shard(jnp.asarray(mask), world)
    args = [jnp.asarray(x) for x in (q, k, v)]
    specs = (P(None, "seq"),) * 3
    if mask is not None:
        args.append(jnp.asarray(mask))
        specs = specs + (P(None, "seq"),)

    def body(q, k, v, m=None):
        return jseq.ring_attention(q, k, v, axis_name="seq",
                                   causal=c["causal"], key_mask=m,
                                   layout=layout,
                                   use_flash=c.get("flash", "auto"))

    f = jax.shard_map(body, mesh=_mesh(world), in_specs=specs,
                      out_specs=P(None, "seq"), check_vma=False)
    out = jax.jit(f)(*args)
    grads = None
    if c.get("grad"):
        grads = jax.jit(jax.grad(lambda *a: (f(*a) ** 2).sum(),
                                 argnums=(0, 1, 2)))(*args)
    return out, grads


def _check_ring(ranks, world, name, c, seed_offset):
    q, k, v = _qkv(seed_offset, hkv=c.get("hkv", 4))
    mask = _mask(seed_offset + 100, world) if c.get("mask") else None
    want, grads = _jax_ring(world, c, q, k, v, mask)
    np.testing.assert_allclose(_gathered(ranks, f"{name}/out"),
                               np.asarray(want), **TOL)
    if grads is not None:
        for x, g in zip("qkv", grads):
            np.testing.assert_allclose(_gathered(ranks, f"{name}/d{x}"),
                                       np.asarray(g), **TOL,
                                       err_msg=f"d{x}")


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_attention_matches_jax(results, name):
    _check_ring(results[4], 4, name, RING[name],
                100 + sorted(RING).index(name))


@pytest.mark.parametrize("name", sorted(RING2))
def test_ring_attention_on_two_ranks_matches_jax(results, name):
    _check_ring(results[2], 2, name, RING2[name],
                100 + sorted(RING2).index(name))


def test_empty_shard_gives_zero_weight(results):
    # Every key of shard 1 is masked: the masked causal ring equals the
    # same ring with those keys dropped from the mask's shard's blocks,
    # i.e. the merge gave shard 1's all-empty rows weight 0 — and the
    # queries of shard 1 whose allowed keys are all masked come out 0.
    name = "mask_causal"
    out = _gathered(results[4], f"{name}/out")
    q, k, v = _qkv(100 + sorted(RING).index(name))
    mask = _mask(200 + sorted(RING).index(name), 4)
    from horovod_tpu.ops.attention import reference_attention

    ref = np.asarray(reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=jnp.asarray(mask), causal=True))
    live = mask.cumsum(axis=1) > 0          # rows with an allowed key
    np.testing.assert_allclose(out[live], ref[live], **TOL)
    assert np.all(out[~live] == 0.0)
    assert (~live).any()


@pytest.mark.parametrize("name", sorted(ULYSSES) + sorted(ULYSSES2))
def test_ulysses_attention_matches_jax(results, name):
    world = 4 if name in ULYSSES else 2
    c = {**ULYSSES, **ULYSSES2}[name]
    order = sorted(ULYSSES if world == 4 else ULYSSES2)
    q, k, v = _qkv(300 + order.index(name), hkv=c.get("hkv", 4))
    f = jax.shard_map(
        lambda q, k, v: jseq.ulysses_attention(q, k, v, axis_name="seq",
                                               causal=c["causal"]),
        mesh=_mesh(world), in_specs=(P(None, "seq"),) * 3,
        out_specs=P(None, "seq"), check_vma=False)
    args = [jnp.asarray(x) for x in (q, k, v)]
    np.testing.assert_allclose(_gathered(results[world], f"{name}/out"),
                               np.asarray(jax.jit(f)(*args)), **TOL)
    if c.get("grad"):
        grads = jax.jit(jax.grad(lambda *a: (f(*a) ** 2).sum(),
                                 argnums=(0, 1, 2)))(*args)
        for x, g in zip("qkv", grads):
            np.testing.assert_allclose(
                _gathered(results[world], f"{name}/d{x}"), np.asarray(g),
                **TOL, err_msg=f"d{x}")


@pytest.mark.parametrize("case", range(len(HEAD_ERRORS)))
def test_ulysses_head_checks_match_jax(results, case):
    hq, hk, hv = HEAD_ERRORS[case]
    f = jax.shard_map(
        lambda q, k, v: jseq.ulysses_attention(q, k, v, axis_name="seq"),
        mesh=_mesh(4), in_specs=(P(None, "seq"),) * 3,
        out_specs=P(None, "seq"), check_vma=False)
    with pytest.raises(ValueError) as info:
        f(*(jnp.zeros((1, 32, h, 8)) for h in (hq, hk, hv)))
    got = str(results[4][0][f"errors/{case}"])
    assert got == str(info.value), (got, str(info.value))


def test_sp_causal_lm_loss_matches_single_device(results):
    from horovod_tpu.models.llama import causal_lm_loss

    rng = np.random.RandomState(7)
    logits = rng.randn(B, S, 50).astype(np.float32)
    ids = rng.randint(0, 50, (B, S))
    full = jax.jit(jax.value_and_grad(causal_lm_loss))(
        jnp.asarray(logits), jnp.asarray(ids))
    for rank in results[4]:
        np.testing.assert_allclose(float(rank["sp_loss/loss"]),
                                   float(full[0]), rtol=1e-6)
    # Each rank's gradient is its shard's share of the global loss's.
    np.testing.assert_allclose(_gathered(results[4], "sp_loss/dlogits"),
                               np.asarray(full[1]), **TOL)


@pytest.mark.parametrize("name", sorted(LLAMA))
def test_sequence_parallel_llama_matches_the_unsharded_model(results, name):
    from horovod_tpu.models.llama import causal_lm_loss

    c = LLAMA[name]
    model, params, ids = _llama_params()
    want = model.apply({"params": params}, jnp.asarray(ids))
    got = results[4]
    if c.get("layout") == "zigzag":
        want = jseq.zigzag_shard(want, 4)
    np.testing.assert_allclose(_gathered(got, f"{name}/logits"),
                               np.asarray(want), **TOL)
    if c.get("grad"):
        grads = _flat(jax.jit(jax.grad(lambda p: causal_lm_loss(
            model.apply({"params": p}, jnp.asarray(ids)),
            jnp.asarray(ids))))(params))
        for key, g in sorted(grads.items()):
            np.testing.assert_allclose(got[0][f"{name}/grad/{key}"],
                                       g.reshape(got[0][
                                           f"{name}/grad/{key}"].shape),
                                       **TOL, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_zigzag_shard_round_trip_matches_jax(world):
    x = np.arange(2 * 32 * 3).reshape(2, 32, 3)
    got = tseq.zigzag_shard(torch.from_numpy(x), world)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jseq.zigzag_shard(jnp.asarray(x), world)))
    np.testing.assert_array_equal(
        tseq.zigzag_unshard(got, world).numpy(), x)
    for idx in range(world):
        np.testing.assert_array_equal(
            tseq.zigzag_positions(idx, 32 // world, world).numpy(),
            np.asarray(jseq.zigzag_positions(idx, 32 // world, world)))
    with pytest.raises(ValueError, match="divisible"):
        tseq.zigzag_shard(torch.zeros(1, 30), world)
