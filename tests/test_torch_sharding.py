"""The port's multi-device launch (``launch/mesh.py``, ``sharding.py``,
``spattn.py``, ``train.py --devices / --mesh``) against the JAX package.

* Rule parity, no process group: every arch of ``ARCHS`` at full size on
  meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16) (``FakeMesh`` objects,
  as the reference's own test), FSDP on and off.  The reference's trees
  come from ``jax.eval_shape``, the port's from its own ``init_params``,
  ``quantize_params`` and ``opt.init`` on fake tensors (no memory; the
  random draws and the per-member packing of expert stacks are replaced
  by shape-only stand-ins, since only shapes reach the rules).  A port
  leaf's spec must equal the reference's for the same leaf — for a layer
  of a stack, the (L, ...) leaf's spec without its layer entry — for
  bf16 parameters, w4a16kv8 packed parameters on the tile layout, AdamW
  and Adafactor state (on the reference's tree, as the checkpoint writes
  it), dense cache slabs, paged pools, tokens and extra inputs.
* The fragment-layout rule: whole 64 × 16 fragments and scale groups a
  shard, the tile rule's decision where the counts agree; for expert
  stacks, E placed as on the tile layout.
* The reference's ``test_production_spec_choices``.
* Sharded ≡ single device, in one spawned gloo group of 4 ranks
  (``tests/torch_dist_worker.py``): each family's REDUCED config (llama4
  with ``big_model``, rwkv6 with the head constraint) on a (2, 2) mesh —
  the loss after 0 and 1 steps within 0.05 of ``training.loop.train``
  (the reference's bound), every parameter's placements kept by the step;
  sequence-parallel prefill on a (1, 4) mesh against one flash call with
  and without window 100 — the output within the reference's 0.03, the
  q / k / v gradients within 2e-2 of their largest value (dK / dV are
  summed over the ranks in bf16 by the reduce-scatter).
* The sharded serve step (``launch.shardserve``) on the (2, 2) mesh: a
  prefill and three decode steps of REDUCED chatglm3 (cache on heads),
  smollm (cache on the sequence), llama4 and rwkv6 under w4a16kv8, each
  call's logits within 2e-2 of the largest single-device logit; llama4's
  again with every packed weight in the card's fragment order, expert
  stacks included.
* The vocab-parallel loss on the (2, 2) mesh, vocab 1023 split
  unevenly: nll and logit gradient against ``log_softmax``; an attention
  merge's gradient sharded across heads (``models.common.merge_heads``).
* The expert-parallel moe FFN on the (2, 2) mesh, both dispatches:
  each rank computes half the experts; output and gradients against the
  plain call.
* The CLI: ``--devices 2 --mesh 1,2`` trains a step and its checkpoint
  restores into the reference's ``training/checkpoint`` tree (spawned
  beside the worker).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.core.precision import get_policy as jget_policy
from repro.launch.sharding import ShardingRules as JRules
from repro.models.registry import build as jbuild
from repro.serving.engine import quantize_params as jquantize
from repro.training import checkpoint as JCKPT
from repro.training import optimizer as JO
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import packing as TPK
from repro_torch.core.precision import get_policy
from repro_torch.launch import mesh as TM
from repro_torch.launch.sharding import ShardingRules, placements
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build
from repro_torch.serving.engine import quantize_params
from repro_torch.training import optimizer as TO
from torch_defaults import package_defaults  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 1), (2, 2), (16, 16), (2, 16, 16)]
POLICY = "w4a16kv8"


class FakeMesh:
    """A mesh by its axis names and sizes only (the reference test's)."""

    def __init__(self, shape):
        self.axis_names = TM.AXES[len(shape)]
        self.shape = dict(zip(self.axis_names, shape))


def _jrules(mesh, cfg, fsdp):
    r = JRules(mesh, cfg, fsdp)
    r.ns = lambda spec: spec             # specs, not NamedShardings
    return r


def _canon(entry):
    """One axis named alone or as a 1-tuple: the same sharding (JAX writes
    the second as the first)."""
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
        else entry


def _norm(spec, ndim):
    """A spec (port tuple or JAX PartitionSpec) as a tuple of ``ndim``
    canonical entries."""
    spec = tuple(_canon(e) for e in spec)
    return spec + (None,) * (ndim - len(spec))


def _key(k):
    return str(getattr(k, "key", getattr(k, "name", k)))


def _jflat(specs, tree):
    """{path of names: (spec, shape)} of a reference tree of specs."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(_key(k) for k in p): (_norm(s, len(leaf.shape)),
                                        tuple(leaf.shape))
            for (p, leaf), s in zip(flat, sflat)}


def _pflat(specs, tree, out=None, path=(), layer=False):
    """{path of names: [(spec, shape, in a stack)]} of a port tree and its
    specs (keys holding "/" split, list items members of one leaf)."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _pflat(specs[k], v, out, path + tuple(str(k).split("/")), layer)
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            _pflat(s, v, out, path, True)
    elif isinstance(tree, TPK.PackedWeight):
        for f in ("data", "scales"):
            out.setdefault(path + (f,), []).append(
                (_norm(specs[f], len(specs[f])),
                 tuple(getattr(tree, f).shape), layer))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if hasattr(v, "shape") or dataclasses.is_dataclass(v):
                _pflat(specs[f.name], v, out, path + (f.name,), layer)
    else:
        out.setdefault(path, []).append(
            (_norm(specs, len(specs)), tuple(tree.shape), layer))
    return out


def _compare(port, ref, complete=True):
    """Every port leaf's spec is the reference's (a stack member's: the
    stacked leaf's without its layer entry), and (``complete``) every
    reference leaf holding data has port leaves."""
    for path, members in port.items():
        assert path in ref, path
        rspec, rshape = ref[path]
        for spec, shape, stacked in members:
            if stacked:
                assert rspec[0] is None, (path, rspec)
                rspec_, rshape_ = rspec[1:], rshape[1:]
            else:
                rspec_, rshape_ = rspec, rshape
            # a port leaf may drop trailing unit dims (per-token scales)
            assert shape == rshape_[:len(shape)], (path, shape, rshape_)
            assert all(s is None for s in rspec_[len(shape):]), path
            assert spec == rspec_[:len(shape)], (path, spec, rspec_)
    for path, (_, shape) in ref.items():
        if complete and np.prod(shape) > 0:
            assert path in port, path


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    """The port's full-size parameter, packed-parameter and optimizer-state
    trees on fake tensors."""
    cfg = get_config(arch)
    mp = pytest.MonkeyPatch()
    bf = torch.bfloat16
    mp.setattr(TC, "dense_init", lambda gen, shape, scale=None:
               torch.empty(tuple(shape), dtype=bf, device=gen.device))
    mp.setattr(TT, "_stack_init", lambda gen, E, shape:
               torch.empty((E,) + tuple(shape), dtype=bf, device=gen.device))

    def pack_stack(w, **kw):       # member 0's packing, E times
        m = TPK.pack_weight(w[0].float(), **kw)
        E = w.shape[0]
        return dataclasses.replace(
            m, data=m.data.expand((E,) + tuple(m.data.shape)),
            scales=m.scales.expand((E,) + tuple(m.scales.shape)))

    mp.setattr(TC, "pack_stack", pack_stack)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = build(cfg).init_params(0, "cpu")
            packed = quantize_params(params, get_policy(POLICY))
            adamw = TO.adamw().init(params)
            adafactor = TO.adafactor().init(params)
    finally:
        mp.undo()
    return cfg, params, packed, {"adamw": adamw, "adafactor": adafactor}


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = jget_config(arch)
    model = jbuild(cfg)
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(model.init_params, key)
    packed = jax.eval_shape(
        lambda k: jquantize(model.init_params(k), jget_policy(POLICY)), key)
    opts = {n: jax.eval_shape(getattr(JO, n)().init, params)
            for n in ("adamw", "adafactor")}
    return cfg, params, packed, opts


def _rules(arch, mesh, fsdp):
    cfg, *_ = _port_trees(arch)
    jcfg, *_ = _ref_trees(arch)
    m = FakeMesh(mesh)
    return ShardingRules(m, cfg, fsdp), _jrules(m, jcfg, fsdp)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    _, params, packed, _ = _port_trees(arch)
    _, jparams, jpacked, _ = _ref_trees(arch)
    for mesh in MESHES:
        for fsdp in (True, False):
            tr, jr = _rules(arch, mesh, fsdp)
            _compare(_pflat(tr.params(params), params),
                     _jflat(jr.params(jparams), jparams))
            _compare(_pflat(tr.params(packed), packed),
                     _jflat(jr.params(jpacked), jpacked))


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_the_reference(arch):
    _, params, _, opts = _port_trees(arch)
    _, jparams, _, jopts = _ref_trees(arch)
    for mesh in MESHES:
        for fsdp in (True, False):
            tr, jr = _rules(arch, mesh, fsdp)
            for name in ("adamw", "adafactor"):
                _compare(_pflat(tr.opt_state(params, opts[name]),
                                opts[name]),
                         _jflat(jr.opt_state(jparams, jopts[name]),
                                jopts[name]))


def _caches(arch):
    """(port, reference) dense caches, and paged pools where the family
    has them, at B 16 / 32 slots."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    pol, jpol = get_policy(POLICY), jget_policy(POLICY)
    model, jmodel = build(cfg), jbuild(jcfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = [(model.init_cache(pol, 16, 4096, "cpu"),
                jmodel.cache_spec(jpol, 16, 4096))]
        if model.init_paged_cache is not None:
            out.append((model.init_paged_cache(pol, 32, 512, 16, 64, "cpu"),
                        jax.eval_shape(lambda: JT.init_paged_cache(
                            jcfg, jpol, 32, 512, 16, 64))))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch):
    """Slabs, pools and recurrent state; the port's block table is one
    layer of the reference's per-layer copies, and the reference's
    ``length`` leaves (an advisory counter) have no port counterpart."""
    for port, ref in _caches(arch):
        for mesh in MESHES:
            tr, jr = _rules(arch, mesh, True)
            ours = _pflat(tr.cache(port), port)
            if ("block_table",) in ours:
                ours[("block_table",)] = [
                    (s, sh, True) for s, sh, _ in ours[("block_table",)]]
            _compare(ours, _jflat(jr.cache(ref), ref), complete=False)


@pytest.mark.parametrize("mesh", MESHES)
def test_token_and_extra_specs_equal_the_reference(mesh):
    for arch in ARCHS:
        tr, jr = _rules(arch, mesh, True)
        for B in (1, 2, 8, 32, 256):
            shape = (B, 128)
            assert _norm(tr.tokens(shape), 2) == _norm(jr.tokens(shape), 2)
            extra = {"img_embeds": (B, 256, 1024), "frames": (B, 1500, 384)}
            want = jr.extra({k: jax.ShapeDtypeStruct(s, np.float32)
                             for k, s in extra.items()})
            got = tr.extra(extra)
            for k, s in extra.items():
                assert _norm(got[k], len(s)) == _norm(want[k], len(s))


def _frag_weights():
    """(arch, name, K, N, group) of every packed 2-D weight of the full
    configs (one layer each), fragment-layout-able."""
    out = []
    for arch in ARCHS:
        _, _, packed, _ = _port_trees(arch)

        def walk(node, name):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, k)
            elif isinstance(node, list):
                if node:
                    walk(node[0], name)
            elif isinstance(node, TPK.PackedWeight) and not node.stacked:
                K, N = node.shape
                if K % 64 == 0 and N % 16 == 0:
                    out.append((arch, name, K, N, node.group, node.block_k,
                                node.block_n))

        walk(packed, "")
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_fragment_layout_spec(mesh):
    """Each shard of the fragment layout holds whole fragments and whole
    scale groups; where the fragment and tile counts divide the same
    axes, the decision is the tile rule's, moved to (N, K)."""
    seen = 0
    for arch, name, K, N, group, bk, bn in _frag_weights():
        tr, _ = _rules(arch, mesh, True)
        p = TPK.PackedWeight(data=torch.empty(0), scales=torch.empty(0),
                             bits=4, group=group, block_k=bk, block_n=bn,
                             shape=(K, N), layout="frag_a16")
        spec = tr.frag_spec(name, p, n_stack=4)
        assert spec[2:] == (None, None)
        sizes = {"N": N // 16, "K": K // np.lcm(64, group)}
        for dim, entry in zip("NK", spec[:2]):
            if entry is not None:
                n = TM.axis_size(FakeMesh(mesh), entry)
                assert sizes[dim] % n == 0, (arch, name, spec)
        tile = tr.reference_spec(name, "data", (4, K // bk, N // bn, bk, bn))
        if (K // bk, N // bn) == (sizes["K"], sizes["N"]):
            assert spec[:2] == (tile[2], tile[1]), (arch, name)
        seen += 1
    assert seen > 50


def _frag_stacks():
    """(arch, name, K, N, group, bk, bn, E) of every packed expert stack
    of the full configs (one layer each)."""
    out = []
    for arch in ARCHS:
        _, _, packed, _ = _port_trees(arch)
        for name, node in packed["layers"][0].items() \
                if isinstance(packed.get("layers"), list) else ():
            if isinstance(node, TPK.PackedWeight) and node.stacked:
                K, N = node.shape
                out.append((arch, name, K, N, node.group, node.block_k,
                            node.block_n, node.n_members))
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_fragment_layout_spec_of_expert_stacks(mesh):
    """An expert stack in the fragment layout (E, N/16, K/64, 32, 4·bits):
    E's entry is the tile stack's, each shard holds whole fragments and
    whole scale groups, and where the fragment and tile counts divide
    the same axes, the N and K decisions are the tile rule's."""
    seen = 0
    for arch, name, K, N, group, bk, bn, E in _frag_stacks():
        tr, _ = _rules(arch, mesh, True)
        p = TPK.PackedWeight(data=torch.empty(0),
                             scales=torch.empty((E, 1, 1)), bits=4,
                             group=group, block_k=bk, block_n=bn,
                             shape=(K, N), layout="frag_a16")
        spec = tr.frag_spec(name, p, n_stack=4)
        tile = tr.reference_spec(name, "data",
                                 (4, E, K // bk, N // bn, bk, bn))
        assert len(spec) == 5 and spec[3:] == (None, None)
        assert spec[0] == tile[1], (arch, name, spec, tile)
        sizes = {"N": N // 16, "K": K // np.lcm(64, group)}
        for dim, entry in zip("NK", spec[1:3]):
            if entry is not None:
                n = TM.axis_size(FakeMesh(mesh), entry)
                assert sizes[dim] % n == 0, (arch, name, spec)
        if (K // bk, N // bn) == (sizes["K"], sizes["N"]):
            assert spec[1:3] == (tile[3], tile[2]), (arch, name)
        seen += 1
    assert seen >= 6


def test_production_spec_choices():
    """On a 16-way model axis: embed shards on vocab, KV falls back to
    sequence-parallel when heads don't divide (the reference test)."""
    cfg = get_config("mistral-large-123b")
    rules = ShardingRules(FakeMesh((16, 16)), cfg)
    assert rules.fsdp == ("data",)
    embed = torch.empty((32768, 12288), dtype=torch.bfloat16, device="meta")
    assert rules.param_spec("embed", embed) == ("model", None)
    kv = torch.empty((88, 128, 32768, 8, 128), dtype=torch.int8,
                     device="meta")
    assert rules._kv_spec(kv) == (None, ("data",), "model", None, None)


def test_placements_read_specs_row_major():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        axis_names = ("pod", "data", "model")
    assert placements((("pod", "data"), "model"), Mesh3()) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements((None, None), Mesh3()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(("model", "model"), Mesh3())


# -- several ranks ------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


#: the CLI run beside the worker: 2 ranks on a (1, 2) mesh, 1 step
CLI = ["--device", "cpu", "--reduced", "--devices", "2", "--mesh", "1,2",
       "--steps", "1", "--batch", "2", "--seq", "16"]


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    """The worker's results and the CLI's output and checkpoint: both
    spawned together, so their ranks start at once."""
    ck = tmp_path_factory.mktemp("cli") / "cli.npz"
    procs = [subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in ([sys.executable, str(ROOT / "tests" /
                                              "torch_dist_worker.py")],
                         [sys.executable, "-m", "repro_torch.launch.train",
                          *CLI, "--checkpoint", str(ck)])]
    (out, err), cli = (p.communicate(timeout=600) for p in procs)
    assert procs[0].returncode == 0, err[-3000:]
    line = [s for s in out.splitlines() if s.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    res["cli"] = (procs[1].returncode, *cli, ck)
    return res


sys.path.insert(0, str(ROOT / "tests"))
from torch_dist_worker import (BATCH, FAMILIES, SEQ,  # noqa: E402
                               SERVE_FAMILIES, STEPS, config)


@pytest.mark.parametrize("arch,big", FAMILIES)
def test_sharded_equals_single_device(dist_results, arch, big):
    from repro_torch.training.loop import train
    single = train(config(arch, big), n_steps=STEPS, batch=BATCH, seq=SEQ,
                   lr=1e-3, log_every=1, device="cpu")
    want = [loss for _, loss in single["losses"]]
    got = dist_results["sharded"][arch]["losses"]
    assert len(got) == len(want) == STEPS
    assert np.abs(np.array(got) - np.array(want)).max() < 0.05, (got, want)


def test_vocab_parallel_nll_equals_log_softmax(dist_results):
    """The sharded step's loss over vocab-sharded logits (each rank its
    range; max and sums over "model") against ``log_softmax`` on one
    device, vocab 1023 split unevenly: nll and logit gradient within f32
    rounding."""
    r = dist_results["nll"]
    assert r["nll_err"] <= 1e-5 * r["nll_scale"], r
    assert r["grad_err"] <= 1e-5 * r["grad_scale"], r


def test_merge_heads_puts_the_gradient_on_whole_heads(dist_results):
    """An attention merge's gradient that comes back sharded on d_model
    over a mesh dim that does not divide the heads (as DTensor may
    reduce-scatter the vocab-parallel loss's partial gradient) is
    gathered before the merge's backward splits it: the input gradient
    is the plain reshape's, exactly."""
    assert dist_results["merge_heads"] == 0.0


@pytest.mark.parametrize("arch,big", FAMILIES)
def test_sharded_step_keeps_placements(dist_results, arch, big):
    assert dist_results["sharded"][arch]["placements_kept"]


@pytest.mark.parametrize("window", ["None", "100"])
def test_sp_attention_matches_flash(dist_results, window):
    res = dist_results["sp"][window]
    err, scale = res["err"], res["scale"]
    assert err[0] < 0.03, res                        # the reference's bar
    for e, s in zip(err[1:], scale[1:]):
        assert e <= 2e-2 * s, res
    assert res["rows_sharded"] == "(Shard(dim=0), Shard(dim=1))"


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_expert_parallel_matches_plain(dist_results, impl):
    """Each rank computes its 2 of REDUCED llama4's 4 experts; the output
    and x's gradient within 1e-2 of their largest value (f32 sums of the
    ranks' experts, rounded once), the router's and the experts'
    gradients within 2e-2 (bf16 sums over the batch ranks), each on its
    parameter's placements."""
    res = dist_results["moe"][impl]
    assert res["experts_a_call"] == [2], res
    assert res["grads_placed"], res
    err, scale = res["err"], res["scale"]
    for e, s, tol in zip(err, scale, [1e-2] * 2 + [2e-2] * 4):
        assert e <= tol * s, res


@pytest.mark.parametrize("arch", [a for a, _ in SERVE_FAMILIES])
def test_sharded_serve_equals_single_device(dist_results, arch):
    """The sharded serve step on the (2, 2) gloo mesh
    (``launch.shardserve``): a prefill and three decode steps of the
    REDUCED config under w4a16kv8, each call's logits within 2e-2 of the
    largest single-device logit (A16); chatglm3's slab is sharded on its
    KV heads, smollm's on the sequence (decode attention combined over
    the ranks by the lse)."""
    res = dist_results["serve"][arch]
    assert len(res["err"]) == 1 + 3, res
    for e, s in zip(res["err"], res["scale"]):
        assert e <= 2e-2 * s, res
    want = {"chatglm3-6b": "heads", "smollm-360m": "sequence"}
    if arch in want:
        assert res["kv_on_model"] == want[arch], res


def test_sharded_serve_of_the_card_s_layout_equals_single_device(
        dist_results):
    """The sharded serve of REDUCED llama4 (FSDP on) with every packed
    weight in the A16 GEMM's fragment order, expert stacks included (the
    card's layout): each call's logits within 2e-2 of the largest
    single-device logit; the expert stack's data placed with E on
    "model" and the tile rule's K decision on its K units; every expert
    run on the kernel's path (its CPU version)."""
    res = dist_results["serve_card_layout"]
    assert len(res["err"]) == 1 + 3, res
    for e, s in zip(res["err"], res["scale"]):
        assert e <= 2e-2 * s, res
    tile = res["tile_stack_spec"]             # (E, Kt, Nt, bk, bn)
    assert res["stack_spec"] == [tile[0], tile[2], tile[1], None, None], res
    assert res["stack_spec"][0] == "model", res
    assert res["experts_packed"] > 0 and res["experts_plain"] == 0, res


def test_cli_devices_and_checkpoint(dist_results):
    rc, out, err, ck = dist_results["cli"]
    assert rc == 0, err[-3000:]
    assert "mesh {'data': 1, 'model': 2}" in out and "step     0  loss" in out
    assert "tokens/s" in out and str(ck) in out
    # the reference restores it into its own training state
    model = jbuild(jget_reduced("smollm-360m"))
    params = model.init_params(jax.random.PRNGKey(1))
    opt = JO.adamw()
    state, step = JCKPT.restore(str(ck), {"params": params,
                                          "opt": opt.init(params)})
    assert step == 1
    leaves = jax.tree_util.tree_leaves(state)
    assert leaves and all(np.isfinite(np.asarray(x, np.float32)).all()
                          for x in leaves)
