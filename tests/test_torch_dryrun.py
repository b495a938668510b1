"""The port's dry-run (``launch/dryrun.py``) against the JAX package's
(``repro.launch.dryrun``), after ``tests/test_dryrun_units.py``.

* Pairs: ``list_pairs()`` and ``SKIPS`` are the reference's (40 pairs, 7
  skips, 33 runnable; a pair is skipped exactly when its arch is not
  sub-quadratic).
* The abstract build (``build_lowerable``) at full size, no process
  group: the reference's seven pairs, every argument leaf fake or meta,
  every spec the reference's leaf for leaf — against the reference's own
  ``build_lowerable`` on a (1, 1) JAX mesh, and against the reference's
  ``ShardingRules`` on a (16, 16) ``FakeMesh`` for the same arguments;
  decode is one token over a full-length cache, training bf16, serving
  packed.
* Abstract shapes: tokens, extra inputs and every family's cache at full
  size, shape and dtype, against the reference's ``ShapeDtypeStruct``s.
* The triangle walk (``core.attention._flash_triangle``) against JAX's
  and against the non-skipping walk; ``block_skip`` and
  ``head_constraint`` set nothing.
* Counts: a REDUCED train step and a REDUCED rwkv6 decode step counted by
  the dry-run on a 1-rank fake mesh against ``analyze_step``'s eager CPU
  count of the same step; ``argument_bytes`` on a (2, 2) fake mesh
  against the local shard bytes the specs give.
* Decode attention with an lse and a key offset (``kernels.ref``): the
  ranges' partial results combine to the whole call.
* The CLI refuses ``--save-hlo`` and records one pair; the private APIs
  the dry-run stands on exist.

The sharded serve step on real gloo ranks is checked with the training
step's in ``tests/torch_dist_worker.py`` (``test_torch_sharding.py``);
the collective counts in ``test_torch_roofline.py``.
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

jax.devices()                     # the backend first: the reference's module
_XLA = os.environ.get("XLA_FLAGS")  # sets XLA_FLAGS at import, for its CLI
from repro.launch import dryrun as JD  # noqa: E402
if _XLA is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import attention as JA  # noqa: E402
from repro.core.precision import get_policy as jget_policy  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.training import data as JDATA  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, get_reduced  # noqa: E402,E501
from repro_torch.core import attention as A  # noqa: E402
from repro_torch.core.packing import PackedWeight  # noqa: E402
from repro_torch.core.precision import get_policy  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.sharding import local_shape  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.roofline import analyze_step  # noqa: E402
from repro_torch.training import data as D  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharding import (FakeMesh, _compare, _jflat,  # noqa: E402
                                 _jrules, _pflat)
from torch_defaults import package_defaults  # noqa: F401

torch.set_num_threads(1)


# -- pairs ------------------------------------------------------------------

def test_pairs_and_skips_equal_the_reference():
    pairs = DR.list_pairs()
    assert pairs == JD.list_pairs()
    assert DR.SKIPS == JD.SKIPS
    assert len(pairs) == len(ARCHS) * len(SHAPES) == 40
    assert len(DR.SKIPS) == 7
    assert all(shape == "long_500k" for _, shape in DR.SKIPS)
    assert len([p for p in pairs if p[2] is None]) == 33
    for a in ARCHS:
        assert ((a, "long_500k") in DR.SKIPS) != get_config(a).sub_quadratic


# -- the abstract build -----------------------------------------------------

REF_PAIRS = [("smollm-360m", "train_4k"), ("smollm-360m", "prefill_32k"),
             ("smollm-360m", "decode_32k"), ("rwkv6-7b", "decode_32k"),
             ("whisper-tiny", "prefill_32k"), ("internvl2-2b", "train_4k"),
             ("recurrentgemma-2b", "long_500k")]


def _abstract(t) -> bool:
    """No storage: a meta tensor or a fake one."""
    return t.device.type == "meta" or type(t).__name__ == "FakeTensor"


def _ref_specs(jrules, jargs, kind):
    """The reference's specs of its own arguments by ``jrules``."""
    if kind == "train":
        p, o, t, g, e = jargs
        return (jrules.params(p), jrules.opt_state(p, o),
                jrules.tokens(t.shape), jrules.tokens(g.shape),
                jrules.extra(e))
    p, t, c, last = jargs
    return (jrules.params(p), jrules.tokens(t.shape), jrules.cache(c),
            jrules.extra(last) if kind == "prefill"
            else jrules.tokens(last.shape))


@pytest.mark.parametrize("arch,shape", REF_PAIRS)
def test_specs_equal_the_reference(arch, shape):
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    _, jargs, jshard, jmeta = JD.build_lowerable(arch, shape, jmesh)
    jspecs11 = jax.tree.map(
        lambda s: s.spec, jshard,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    kind = jmeta["kind"]
    for mesh in ((1, 1), (16, 16)):
        fn, args, specs, meta = DR.build_lowerable(arch, shape,
                                                   FakeMesh(mesh))
        assert (meta["kind"], meta["policy"], meta["seq"], meta["batch"]) \
            == (kind, jmeta["policy"], jmeta["seq"], jmeta["batch"])
        assert len(args) == len(specs) == len(jargs)
        for leaf in DR._leaves(args):
            assert _abstract(leaf), (arch, shape, type(leaf), leaf.device)
        if mesh == (1, 1):
            want = jspecs11
        else:
            fsdp = kind == "train" or "no_serve_fsdp" not in DR._OPTS
            want = _ref_specs(_jrules(FakeMesh(mesh), jget_config(arch),
                                      fsdp), jargs, kind)
        for i, (a, s, ja, js) in enumerate(zip(args, specs, jargs, want)):
            cache = kind != "train" and i == 2
            _compare(_pflat(s, a), _jflat(js, ja), complete=not cache)


def test_decode_is_one_token_over_the_full_cache():
    _, args, _, meta = DR.build_lowerable("chatglm3-6b", "decode_32k",
                                          FakeMesh((1, 1)))
    assert tuple(args[1].shape) == (128, 1)
    assert args[2].k.shape[2] == 32_768
    assert tuple(args[3].shape) == (128,)
    assert meta["host_pos"] == 32_767


def test_train_uses_bf16_and_serving_packed_weights():
    _, args, _, meta = DR.build_lowerable("smollm-360m", "train_4k",
                                          FakeMesh((1, 1)))
    assert meta["policy"] == "w16a16kv16"
    assert not any(isinstance(x, PackedWeight) for x in _nodes(args[0]))
    assert all(x.dtype == torch.bfloat16 for x in DR._leaves(args[0]))
    _, args, _, meta = DR.build_lowerable("smollm-360m", "decode_32k",
                                          FakeMesh((1, 1)))
    assert meta["policy"] == "w4a16kv8"
    assert any(isinstance(x, PackedWeight) for x in _nodes(args[0]))


def _nodes(tree):
    if isinstance(tree, dict):
        return [n for v in tree.values() for n in _nodes(v)]
    if isinstance(tree, (list, tuple)):
        return [n for v in tree for n in _nodes(v)]
    return [tree]


# -- abstract shapes ----------------------------------------------------------

def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _shapes(tree, path=()):
    """{path: (shape, dtype)} of a port cache (dataclasses of tensors)."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_shapes(getattr(tree, f.name), path + (f.name,)))
        return out
    return {path: (tuple(tree.shape), _dtype(tree.dtype))}


def _jshapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "name", k)) for k in p):
            (tuple(x.shape), str(np.dtype(x.dtype))) for p, x in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_shapes_equal_the_reference(arch):
    """Tokens, extra inputs and caches at full size; the port's slabs drop
    the reference's ``length`` counter and the scales' unit axis."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = build(cfg), jbuild(jcfg)
    toks, jtoks = D.token_specs(8, 4096), JDATA.token_specs(8, 4096)
    for k in ("tokens", "targets"):
        assert tuple(toks[k].shape) == jtoks[k].shape
        assert _dtype(toks[k].dtype) == str(np.dtype(jtoks[k].dtype))
    ex, jex = model.extra_specs(4), jmodel.extra_input_specs(4)
    assert set(ex) == set(jex)
    for k in ex:
        assert tuple(ex[k].shape) == jex[k].shape
        assert _dtype(ex[k].dtype) == str(np.dtype(jex[k].dtype))
    cache = model.cache_spec(get_policy("w4a16kv8"), 16, 32_768)
    jcache = jmodel.cache_spec(jget_policy("w4a16kv8"), 16, 32_768)
    ours, ref = _shapes(cache), _jshapes(jcache)
    assert all(t.device.type == "meta" for t in DR._leaves(cache))
    assert set(ours) == {p for p in ref if p[-1] != "length"}
    for p, (shape, dt) in ours.items():
        rshape, rdt = ref[p]
        assert rshape[:len(shape)] == shape and \
            all(n == 1 for n in rshape[len(shape):]), (p, shape, rshape)
        assert dt == rdt, (p, dt, rdt)


# -- the triangle walk --------------------------------------------------------

@pytest.mark.parametrize("window", [None, 100])
def test_flash_triangle_equals_jax_and_the_full_walk(window):
    rng = np.random.default_rng(15)
    B, S, H, Hkv, Dh, blk = 1, 300, 4, 2, 32, 128
    q, k, v = (rng.standard_normal((B, S, h, Dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    ours = A._flash_triangle(tq, tk, tv, window=window, block=blk).float()
    jq, jk, jv = (jax.numpy.asarray(t.float().numpy()).astype(
        jax.numpy.bfloat16) for t in (tq, tk, tv))
    want = np.asarray(JA._flash_triangle(jq, jk, jv, window=window,
                                         q_chunk=blk, kv_chunk=blk)
                      .astype(jax.numpy.float32))
    top = np.abs(want).max()
    assert np.abs(ours.numpy() - want).max() <= 1e-2 * top
    walk = A.flash_attention(tq, tk, tv, causal=True, window=window).float()
    assert (ours - walk).abs().max().item() <= 2e-2 * top


def test_block_skip_and_head_constraint_set_no_state():
    """The port's step always skips the tiles above the diagonal and
    always constrains rwkv's heads, so the two options are accepted and
    change no call: flash attention keeps its bits and nothing is
    installed."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 600, 2, 32), generator=g).to(torch.bfloat16)
               for _ in range(3))
    before = A.flash_attention(q, k, v, causal=True)
    DR.set_optimizations(["block_skip", "head_constraint"])
    try:
        after = A.flash_attention(q, k, v, causal=True)
        assert A.SP_PREFILL is None
    finally:
        DR.set_optimizations([])
    assert torch.equal(before, after)
    tri = A._flash_triangle(q, k, v)
    assert (before.float() - tri.float()).abs().max() <= \
        2e-2 * tri.float().abs().max()


# -- decode attention with an lse and a key range -----------------------------

@pytest.mark.parametrize("window", [None, 40])
def test_kvattn_ref_key_ranges_combine_to_the_whole(window):
    """Three key ranges that split S 96 (one past every frontier, so its
    rows keep nothing): the ranges' outputs combined by their lse equal the
    whole call within 2e-2 of its largest element; a row with no key in a
    range has lse -inf and output 0."""
    from repro_torch.core import kvcache as KV
    from repro_torch.core.quantize import quantize_kv
    spec = get_policy("w4a16kv8").kv
    g = torch.Generator().manual_seed(25)
    B, S, Hkv, rep, Dh, T = 2, 96, 2, 3, 32, 2
    slab = KV.init_cache(B, S, Hkv, Dh, spec, device="cpu").layer(0)
    for buf, sc in ((slab.k, slab.k_scale), (slab.v, slab.v_scale)):
        qv, s = quantize_kv(torch.randn((B, S, Hkv, Dh), generator=g)
                            .to(torch.bfloat16), spec)
        buf.copy_(qv)
        sc.copy_(s[..., 0])
    q = torch.randn((B, Hkv, T * rep, Dh), generator=g).to(torch.bfloat16)
    pos = torch.tensor([50, 20], dtype=torch.int32)
    win = REF.NO_WINDOW if window is None else window
    whole = REF.kvattn_ref(q, slab.k, slab.k_scale, slab.v, slab.v_scale,
                           pos, win, rep, 16)
    outs, lses = [], []
    for lo, hi in ((0, 32), (32, 64), (64, 96)):
        o, ls = REF.kvattn_ref(q, *(t[:, lo:hi] for t in (
            slab.k, slab.k_scale, slab.v, slab.v_scale)), pos, win, rep, 16,
            key_offset=lo, return_lse=True)
        none = torch.isinf(ls)
        assert (ls[none] < 0).all() and (o.float()[none] == 0).all()
        outs.append(o)
        lses.append(ls)
    assert torch.isinf(lses[2]).all()             # keys past every frontier
    comb = REF.combine_lse(outs, lses)
    top = whole.float().abs().max()
    assert (comb.float() - whole.float()).abs().max() <= 2e-2 * top
    # offset 0: the lse's unrounded f32 output rounds to the bits of the
    # call without it
    o0, _ = REF.kvattn_ref(q, slab.k, slab.k_scale, slab.v, slab.v_scale,
                           pos, win, rep, 16, 0, True)
    assert o0.dtype == torch.float32
    assert torch.equal(o0.to(torch.bfloat16), whole)


def test_kvattn_cost_charges_the_range_only():
    from repro_torch.kernels import cost as KC
    full = KC.decode_attention([95, 95], 1, 3, 5, 64, REF.NO_WINDOW, 64)
    parts = [KC.decode_attention([95, 95], 1, 3, 5, 64, REF.NO_WINDOW, 64,
                                 key_lo=lo, key_hi=lo + 32)
             for lo in (0, 32, 64)]
    assert sum(p[0] for p in parts) == full[0]
    head = 2 * 2 * 5 * 3 * 64 * 2 + 2 * 4    # q and out, positions
    assert sum(p[1] for p in parts) == full[1] + 2 * head


# -- counts ------------------------------------------------------------------

def _eager_train(cfg, seq, batch):
    from repro_torch.training import optimizer as O
    from repro_torch.training.loop import make_train_step, tree_map
    model = build(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      model.init_params(0, "cpu"))
    opt = O.for_config(cfg)
    state = opt.init(params)
    toks, tgts = next(D.batches(cfg.vocab, batch, seq, 1, seed=1,
                                device="cpu"))
    step = make_train_step(model, opt, remat=True)
    return analyze_step(step, params, state, toks, tgts, arch=cfg.name,
                        shape="t", cfg=cfg, seq=seq, batch=batch,
                        kind="train")


def _eager_decode(cfg, batch, host_pos):
    from repro_torch.serving.engine import quantize_params
    model = build(cfg)
    pol = get_policy(DR.SERVING_POLICY)
    params = quantize_params(model.init_params(0, "cpu"), pol)
    cache = model.init_cache(pol, batch, host_pos + 1, "cpu")
    toks = torch.ones((batch, 1), dtype=torch.int32)
    pos = torch.full((batch,), host_pos, dtype=torch.int32)
    with torch.no_grad():
        return analyze_step(model.decode_step, params, pol, toks, cache, pos,
                            arch=cfg.name, shape="d", cfg=cfg, seq=1,
                            batch=batch, kind="decode")


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", (64, 2, "train")), ("rwkv6-7b", (64, 4, "decode"))])
def test_one_rank_count_equals_the_eager_count(arch, shape):
    """The dry-run's count of a REDUCED step on a 1-rank fake mesh against
    ``analyze_step``'s eager CPU count of the same step: matmul FLOPs
    exactly; other FLOPs and bytes within 1%.  The ops that differ are the
    sharded step's embedding lookups: the decode's in a vocab-sharded
    table (``shardserve.sharded_embed``: a masked local lookup — ``sub``,
    ``ge``, ``lt``, ``bitwise_and``, ``clamp``, ``zeros_like``, ``where``
    beside the ``index``), the training step's through ``F.embedding``
    (``embedding`` and ``embedding_dense_backward`` on a ``new_zeros``
    table, where the eager step indexes: ``index``, ``index_put``).  The
    collectives of a 1-rank group move no wire bytes."""
    cfg = get_reduced(arch)
    seq, batch, kind = shape
    rec = DR.run_pair(arch, shape, mesh_shape=(1, 1), cfg=cfg)
    got = rec["device_counts"]
    eager = (_eager_train(cfg, seq, batch) if kind == "train" else
             _eager_decode(cfg, batch, seq + cfg.n_img_tokens - 1)).cost
    assert got["matmul_flops"] == eager.matmul_flops, (got, eager)
    assert abs(got["other_flops"] - eager.other_flops) <= \
        0.01 * eager.other_flops, (got, eager)
    assert abs(got["bytes"] - eager.bytes) <= 0.01 * eager.bytes, \
        (got, eager)
    assert rec["roofline"]["coll_bytes_dev"] == 0.0
    assert rec["roofline"]["hlo_flops"] == got["matmul_flops"] + \
        got["other_flops"]


def test_argument_bytes_are_the_local_shard_bytes():
    """REDUCED smollm decode on a (2, 2) fake mesh: ``argument_bytes`` is
    the sum over the arguments of their local shards' bytes by the specs,
    the peak at least that, temp the difference, and the model axis moves
    collective bytes."""
    cfg = get_reduced("smollm-360m")
    shape = (64, 4, "decode")
    rec = DR.run_pair("smollm-360m", shape, mesh_shape=(2, 2), cfg=cfg)
    _, args, specs, _ = DR.build_lowerable("smollm-360m", shape,
                                           FakeMesh((2, 2)), cfg=cfg)
    mesh = FakeMesh((2, 2))
    total = 0
    for leaf, spec in zip(DR._leaves(args), _spec_leaves(specs)):
        total += int(np.prod(local_shape(leaf.shape, spec, mesh))) * \
            leaf.element_size()
    mem = rec["memory"]
    assert mem["argument_bytes"] == total > 0
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert rec["roofline"]["coll_bytes_dev"] > 0


def _spec_leaves(specs):
    """The specs of :func:`dryrun._leaves`' tensors, in its order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list) or (isinstance(specs, tuple) and specs and
                                   not all(e is None or isinstance(
                                       e, (str, tuple)) for e in specs)):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


# -- the CLI and the private APIs ---------------------------------------------

def test_cli_refuses_save_hlo_and_records_a_pair(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--save-hlo", str(tmp_path / "x.hlo")])
    assert e.value.code == 2
    assert "no HLO" in capsys.readouterr().err
    out = tmp_path / "dry.jsonl"
    assert DR.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                    "--out", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "skipped" and rec["mesh"] == "16x16"
    assert rec["torch"] == torch.__version__


def test_private_apis_the_dry_run_stands_on():
    """Pinned: ``FakeStore`` and the "fake" backend, ``MemTracker``'s
    snapshot, DTensor's propagation entries and the functional
    collectives' names (``roofline.op_cost``)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert FakeStore and hasattr(MemTracker(), "get_tracker_snapshot")
    assert hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
    prop = DTensor._op_dispatcher.sharding_propagator
    assert callable(prop.propagate_op_sharding)
    assert callable(prop.propagate_op_sharding_non_cached)
    for n in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single", "wait_tensor"):
        assert hasattr(torch.ops._c10d_functional, n), n
