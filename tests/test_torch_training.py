"""The port's training substrate against the JAX package (CPU): data,
optimizers, checkpoints, the loop, the CLI and the examples.

* ``batches``: the same tokens and targets as ``repro.training.data``,
  bit for bit (the corpus is the reference's numpy code).
* Optimizers on a stacked tree (llama4-scout REDUCED: norm gains (L, d),
  projections (L, d, f), expert stacks (L, E, d, f), top-level embed /
  norm / head), norm gains randomized, three updates with the same bf16
  gradients, each from JAX's parameters and state: every parameter
  within 1 bf16 ulp of JAX's (at the larger of its old and new value:
  f32 sums in other orders may round to the neighbouring bf16), the f32
  moments (AdamW ``mu`` / ``nu``, Adafactor ``vr`` / ``vc`` / ``v``)
  within 1e-6 of each leaf's largest element (a moment summed from
  gradients of both signs cancels, so elementwise it has no relative
  bar).  The same updates applied per layer (each layer
  its own leaf: no decay of gains, unfactored gain moments, per-layer
  ``rms_u`` and ``scale``) miss JAX's by many ulps: the stacked-leaf
  semantics are what the parity rests on.
* Checkpoints: every dtype round-trips bit for bit; a leaf-count, path
  or shape mismatch is refused; a flat tree saved by either package
  restores in the other, with the same arrays, tags and key paths.  The
  checkpoint of a ``train()`` run holds the reference's tree (layer
  stacks as (L, ...) leaves, optimizer groups nested): one step of each
  package's ``train()`` (REDUCED smollm-360m with AdamW, REDUCED
  llama4-scout with Adafactor) writes the same index — leaf count,
  order, key paths, tags — and each file restores into the other
  package's state bit for bit (restored and saved again, it gives the
  writer's bytes).  Every other family's state (parameters from
  ``convert.params_from_jax``, the optimizer's initial state) saves as
  JAX's ``_flatten`` of the same state, value for value, and round-trips
  both ways — recurrentgemma REDUCED's ``trail`` stack has no layers.
* Mirrors of ``tests/test_training.py``: both optimizers converge, the
  Adafactor state is factored, ``for_config`` picks Adafactor for
  ``big_model``, the loss descends, a whisper step runs; remat gives the
  same gradients bit for bit; the CLI and the examples run on the CPU,
  and a multi-device mesh whose size is not ``--devices`` is refused.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.models.registry import build as j_build
from repro.training import checkpoint as JCK
from repro.training import data as JD
from repro.training import optimizer as JO
from repro.training.loop import train as j_train
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core.precision import get_policy
from repro_torch.models.registry import build
from repro_torch.training import checkpoint as CK
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training.loop import empty_state, train, tree_map
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,n,seed", [
    (1000, 2, 16, 3, 5), (1024, 4, 64, 2, 0), (49152, 8, 128, 1, 3)])
def test_batches_bit_for_bit_with_jax(vocab, batch, seq, n, seed):
    got = list(D.batches(vocab, batch, seq, n, seed, device="cpu"))
    want = list(JD.batches(vocab, batch, seq, n, seed))
    assert len(got) == len(want) == n
    for (tt, gt), (tj, gj) in zip(got, want):
        assert tt.dtype == gt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_next_token_alignment():
    toks, tgts = next(D.batches(1000, 2, 16, 1, device="cpu"))
    flat = D.SyntheticCorpus(1000, 0).stream(2 * 17).reshape(2, 17)
    np.testing.assert_array_equal(toks.numpy(), flat[:, :-1])
    np.testing.assert_array_equal(tgts.numpy(), flat[:, 1:])


def test_corpus_has_structure():
    s = D.SyntheticCorpus(500, 0).stream(5000)
    assert len(set(zip(s[:-1].tolist(), s[1:].tolist()))) < 4000


# ---------------------------------------------------------------------------
# Optimizers on a stacked tree
# ---------------------------------------------------------------------------

ARCH = "llama4-scout-17b-a16e"
#: (name, JAX constructor, port constructor) — lr large enough that one
#: step of AdamW's decay moves a gain near 0.5 by more than a bf16 ulp
OPTS = {"adamw": (lambda: JO.adamw(lr=5e-2, warmup=1, total_steps=3),
                  lambda: O.adamw(lr=5e-2, warmup=1, total_steps=3)),
        "adafactor": (lambda: JO.adafactor(lr=5e-2),
                      lambda: O.adafactor(lr=5e-2))}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 units in the last place between a and b, elementwise."""
    def ordered(t):
        i = t.detach().to(torch.bfloat16).contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude."""
    m = t.detach().float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _stacked_tree():
    """JAX params of a REDUCED moe model (1-D leaves set to 0.5 + noise)
    and three bf16 gradient trees of the same structure, as numpy."""
    cfg = j_reduced(ARCH)
    params = jax.device_get(j_build(cfg).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def gain(a):
        if np.asarray(a).ndim == 1 or (np.asarray(a).ndim == 2 and
                                       a.shape[-1] == cfg.d_model and
                                       a.shape[0] == cfg.n_layers):
            return (0.5 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree.map(gain, params)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2)
                          .astype(a.dtype), params) for _ in range(3)]
    return cfg, params, grads


def _names(tree):
    """JAX leaves by the port's group name ("layers/wq", "embed"; an
    Adafactor moment "layers/wq/vr")."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): leaf for path, leaf in flat}


def _port_state(sj, opt_name):
    """A JAX optimizer state in the port's layout (one stacked tensor per
    group, keyed by its path)."""
    step = torch.tensor(int(sj["step"]), dtype=torch.int32)
    if opt_name == "adamw":
        return {k: {n: to_tensor(np.asarray(v), "cpu")
                    for n, v in _names(sj[k]).items()}
                for k in ("mu", "nu")} | {"step": step}
    m = {}
    for n, v in _names(sj["m"]).items():
        group, part = n.rsplit("/", 1)
        m.setdefault(group, {})[part] = to_tensor(np.asarray(v), "cpu")
    return {"m": m, "step": step}


def _moments(state):
    """(name, tensor) of every moment of a port state."""
    return [(name, ms[0]) for name, (_, ms) in O.leaf_groups(
        {k: v for k, v in state.items() if k != "step"}).items()]


def _port_tree(np_tree, per_layer=False):
    t = params_from_jax(np_tree, get_reduced(ARCH), "cpu")
    if per_layer:
        layers = t.pop("layers")
        t.update({f"layer{i}": lp for i, lp in enumerate(layers)})
    return t


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_matches_jax_on_stacked_leaves(opt_name):
    """Each of three updates from JAX's parameters and state: the port's
    new parameters within 1 bf16 ulp (at the larger of the old and new
    value) and its moments within 1e-6 of each leaf's largest element."""
    _, params, grads = _stacked_tree()
    make_j, make_t = OPTS[opt_name]
    opt_j, opt_t = make_j(), make_t()
    pj = jax.tree.map(jnp.asarray, params)
    sj = opt_j.init(pj)
    upd = jax.jit(opt_j.update)
    for g in grads:
        pt, st = _port_tree(jax.device_get(pj)), _port_state(sj, opt_name)
        old = O.leaf_groups(_port_tree(jax.device_get(pj)))
        pj, sj = upd(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = opt_t.update(_port_tree(g), st, pt)
        want, got = O.leaf_groups(_port_tree(jax.device_get(pj))), \
            O.leaf_groups(pt)
        assert want.keys() == got.keys()
        for name, (_, members) in want.items():
            for w, p, p0 in zip(members, got[name][1], old[name][1]):
                assert p.dtype == w.dtype
                bar = _ulp(torch.maximum(w.float().abs(), p0.float().abs()))
                assert bool(((p.float() - w.float()).abs() <= bar).all()), \
                    name
        want_m = _port_state(sj, opt_name)
        assert int(st["step"]) == int(want_m["step"])
        got_m = dict(_moments(st))
        assert len(got_m) >= len(want)
        for name, w in _moments(want_m):
            err = (got_m[name] - w).abs().max().item()
            assert err <= 1e-6 * w.abs().max().item(), (name, err)


def _run_per_layer(opt_name):
    """Three updates by JAX, and by the port with each layer its own
    leaf."""
    _, params, grads = _stacked_tree()
    make_j, make_t = OPTS[opt_name]
    opt_j, opt_t = make_j(), make_t()
    pj = jax.tree.map(jnp.asarray, params)
    sj = opt_j.init(pj)
    upd = jax.jit(opt_j.update)
    pt = _port_tree(params, per_layer=True)
    st = opt_t.init(pt)
    for g in grads:
        pj, sj = upd(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = opt_t.update(_port_tree(g, per_layer=True), st, pt)
    return pj, pt


@pytest.mark.parametrize("opt_name,leaf", [
    ("adamw", "ln1"), ("adamw", "ln2"), ("adafactor", "ln1"),
    ("adafactor", "wq")])
def test_per_layer_semantics_miss_jax(opt_name, leaf):
    """The check above would fail on per-layer updates: AdamW leaves a
    per-layer gain undecayed, Adafactor gives it an unfactored moment and
    takes ``rms_u`` / ``scale`` per layer."""
    pj, pt = _run_per_layer(opt_name)
    want = to_tensor(np.asarray(pj["layers"][leaf][0]), "cpu")
    assert _ulps(pt["layer0"][leaf], want).max().item() > 1


def test_adafactor_state_factors_stacked_gains():
    _, params, _ = _stacked_tree()
    cfg = get_reduced(ARCH)
    st = O.adafactor().init(params_from_jax(params, cfg, "cpu"))
    L, d, E, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    assert st["m"]["layers/ln1"]["vr"].shape == (L,)
    assert st["m"]["layers/ln1"]["vc"].shape == (d,)
    assert st["m"]["layers/we1"]["vr"].shape == (L, E, d)
    assert st["m"]["layers/we1"]["vc"].shape == (L, E, f)
    assert st["m"]["final_norm"]["v"].shape == (d,)
    flat = O.adafactor().init({"w": torch.zeros((64, 32)),
                               "b": torch.zeros((64,))})
    assert flat["m"]["w"]["vr"].shape == (64,)
    assert flat["m"]["w"]["vc"].shape == (32,)
    assert flat["m"]["b"]["v"].shape == (64,)


def _quadratic(opt, params, steps):
    state = opt.init(params)
    for _ in range(steps):
        grads = tree_map(lambda p: 2 * (p - 3.0), params)
        params, state = opt.update(grads, state, params)
    return max(float((p - 3.0).abs().max())
               for _, ms in O.leaf_groups(params).values() for p in ms)


def test_adamw_converges():
    params = {"x": torch.tensor([10.0, -4.0])}
    assert _quadratic(O.adamw(lr=0.3, weight_decay=0.0, warmup=5,
                              total_steps=200), params, 200) < 0.5


def test_adafactor_converges():
    params = {"w": torch.full((4, 4), 10.0)}
    assert _quadratic(O.adafactor(lr=0.1), params, 300) < 1.0


def test_for_config_selects():
    big = dataclasses.replace(get_reduced("mistral-large-123b"),
                              big_model=True)
    assert "m" in O.for_config(big).init({"x": torch.zeros(2)})
    assert "mu" in O.for_config(get_reduced("smollm-360m")).init(
        {"x": torch.zeros(2)})


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(4, 4, generator=g).to(torch.bfloat16),
        "f32": torch.randn(3, generator=g),
        "i32": torch.arange(5, dtype=torch.int32),
        "nested": {"fp8": torch.randn(2, 2, generator=g).to(
            torch.float8_e4m3fn),
            "e5m2": torch.randn(3, generator=g).to(torch.float8_e5m2)},
        "layers": [{"w": torch.randn(2, 3, generator=g).to(torch.bfloat16)}
                   for _ in range(2)],
        "step": torch.zeros((), dtype=torch.int32),
    }


def test_roundtrip_all_dtypes(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck.npz")
    CK.save(path, tree, step=7)
    out, step = CK.restore(path, tree)
    assert step == 7
    assert list(out) == list(tree) and len(out["layers"]) == 2
    a = O.leaf_groups(tree)
    b = O.leaf_groups(out)
    for name, (_, ms) in a.items():
        for x, y in zip(ms, b[name][1]):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                               y.view(torch.uint8) if y.dim() else y)


def test_mismatch_refused(tmp_path):
    path = str(tmp_path / "ck.npz")
    CK.save(path, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        CK.restore(path, {"x": torch.zeros(5)})
    with pytest.raises(ValueError, match="leaves"):
        CK.restore(path, {"x": torch.zeros(4), "y": torch.zeros(1)})
    with pytest.raises(ValueError, match="where the model has"):
        CK.restore(path, {"w": torch.zeros(4)})


def test_checkpoints_cross_load_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    flat = {"b": rng.standard_normal((3, 4)).astype(np.float32),
            "a": rng.standard_normal((4,)).astype(np.float32),
            "c": np.arange(6, dtype=np.int32)}
    tree_j = {"b": jnp.asarray(flat["b"], jnp.bfloat16),
              "a": jnp.asarray(flat["a"]),
              "c": jnp.asarray(flat["c"]),
              "d": jnp.asarray(flat["a"], jnp.float8_e4m3fn)}
    tree_t = {k: to_tensor(np.asarray(v), "cpu") for k, v in tree_j.items()}
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JCK.save(pj, tree_j, step=3)
    CK.save(pt, tree_t, step=3)
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert str(zj["__index__"]) == str(zt["__index__"])
        for k in zj.files:
            if k != "__index__":
                assert zj[k].dtype == zt[k].dtype
                np.testing.assert_array_equal(zj[k], zt[k])
    got_t, step_t = CK.restore(pj, tree_t)
    got_j, step_j = JCK.restore(pt, tree_j)
    assert step_t == step_j == 3
    for k in tree_t:
        assert torch.equal(got_t[k].view(torch.uint8),
                           tree_t[k].view(torch.uint8))
        np.testing.assert_array_equal(
            np.asarray(got_j[k]).view(np.uint8),
            np.asarray(tree_j[k]).view(np.uint8))


def _index(path):
    with np.load(path) as z:
        return json.loads(str(z["__index__"]))


def _same_files(a, b):
    """Two checkpoint files hold the same index and the same bytes."""
    with np.load(a) as za, np.load(b) as zb:
        assert str(za["__index__"]) == str(zb["__index__"])
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k != "__index__":
                assert za[k].dtype == zb[k].dtype, k
                assert za[k].shape == zb[k].shape, k
                assert za[k].tobytes() == zb[k].tobytes(), k


@pytest.mark.parametrize("arch,big_model", [("smollm-360m", False),
                                            ("llama4-scout-17b-a16e", True)])
def test_train_checkpoints_cross_load_with_jax(tmp_path, arch, big_model):
    """One step of each package's ``train()`` with ``checkpoint_every=1``
    (llama4 as a big model: Adafactor): the same reference tree, and each
    file restores into the other package's state bit for bit."""
    jcfg = dataclasses.replace(j_reduced(arch), big_model=big_model)
    tcfg = dataclasses.replace(get_reduced(arch), big_model=big_model)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    kw = dict(n_steps=1, batch=2, seq=16, log_every=1, checkpoint_every=1)
    res_j = j_train(jcfg, checkpoint_path=pj, **kw)
    res_t = train(tcfg, checkpoint_path=pt, device="cpu", **kw)
    assert _index(pj) == _index(pt)
    assert ("['opt']['m']" if big_model else "['opt']['mu']") in \
        _index(pt)["leaves"][0]["path"]
    with np.load(pj) as zj, np.load(pt) as zt:
        for k in zj.files:
            assert (zj[k].dtype, zj[k].shape) == (zt[k].dtype, zt[k].shape)

    like_t = {"params": res_t["params"], "opt": res_t["opt_state"]}
    got_t, step_t = CK.restore(pj, like_t)          # JAX's run, port's tree
    layers = got_t["params"]["layers"]
    assert len(layers) == tcfg.n_layers
    assert layers[0]["wq"].untyped_storage().data_ptr() != \
        layers[1]["wq"].untyped_storage().data_ptr()
    CK.save(str(tmp_path / "t2.npz"), got_t, step=step_t)
    _same_files(pj, str(tmp_path / "t2.npz"))

    like_j = {"params": res_j["params"], "opt": res_j["opt_state"]}
    got_j, step_j = JCK.restore(pt, like_j)         # port's run, JAX's tree
    JCK.save(str(tmp_path / "j2.npz"), got_j, step=step_j)
    _same_files(pt, str(tmp_path / "j2.npz"))
    assert step_t == step_j == 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "internvl2-2b", "rwkv6-7b",
                                  "recurrentgemma-2b", "whisper-tiny"])
def test_state_of_every_family_saves_the_reference_tree(tmp_path, arch):
    jcfg, tcfg = j_reduced(arch), get_reduced(arch)
    raw = jax.device_get(j_build(jcfg).init_params(jax.random.PRNGKey(0)))
    state_j = {"params": raw, "opt": JO.for_config(jcfg).init(raw)}
    params = params_from_jax(raw, tcfg, device="cpu")
    opt = O.for_config(tcfg)
    state_t = {"params": params, "opt": opt.init(params)}
    empty = empty_state(build(tcfg), opt)
    assert (empty is not None) == (arch == "recurrentgemma-2b")
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    CK.save(pt, state_t, step=5, empty=empty)
    JCK.save(pj, state_j, step=5)
    _same_files(pj, pt)
    # both files restore into the port's state and save back unchanged
    for src in (pt, pj):
        got, step = CK.restore(src, state_t, empty=empty)
        assert step == 5
        CK.save(str(tmp_path / "again.npz"), got, step=step, empty=empty)
        _same_files(pt, str(tmp_path / "again.npz"))
    got_j, _ = JCK.restore(pt, state_j)
    JCK.save(str(tmp_path / "j2.npz"), got_j, step=5)
    _same_files(pj, str(tmp_path / "j2.npz"))
    if empty is not None:
        with pytest.raises(ValueError, match="leaves"):
            CK.restore(pj, state_t)


# ---------------------------------------------------------------------------
# The loop, remat, the CLI and the examples
# ---------------------------------------------------------------------------


def test_loss_descends():
    res = train(get_reduced("smollm-360m"), n_steps=40, batch=4, seq=64,
                lr=3e-3, log_every=39, device="cpu")
    first, last = res["losses"][0][1], res["losses"][-1][1]
    assert last < first - 0.2, (first, last)


def test_single_step_runs():
    res = train(get_reduced("whisper-tiny"), n_steps=2, batch=2, seq=16,
                log_every=1, device="cpu")
    assert len(res["losses"]) == 2 and len(res["step_s"]) == 2
    assert all(np.isfinite(v) for _, v in res["losses"])


def test_checkpoint_of_a_run_restores(tmp_path):
    path = str(tmp_path / "run.npz")
    res = train(get_reduced("smollm-360m"), n_steps=2, batch=2, seq=16,
                log_every=1, checkpoint_path=path, checkpoint_every=2,
                device="cpu")
    like = {"params": res["params"], "opt": res["opt_state"]}
    out, step = CK.restore(path, like)
    assert step == 2
    assert torch.equal(out["params"]["embed"], res["params"]["embed"])
    assert torch.equal(out["opt"]["mu"]["layers/wq"],
                       res["opt_state"]["mu"]["layers/wq"])


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b",
                                  "rwkv6-7b", "whisper-tiny",
                                  "internvl2-2b"])
def test_remat_gives_the_same_gradients(arch):
    cfg = get_reduced(arch)
    model = build(cfg)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    tgts = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    extra = model.extra_inputs(2, 2, "cpu")
    pol = get_policy("w16a16kv16")
    grads = []
    for remat in (False, True):
        params = tree_map(lambda p: p.requires_grad_(True),
                          model.init_params(0, "cpu"))
        loss = model.loss_fn(params, pol, toks, tgts, remat=remat, **extra)
        loss.backward()
        grads.append((loss.detach(), O.leaf_groups(
            tree_map(lambda p: p.grad, params))))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, (_, ms) in grads[0][1].items():
        for a, b in zip(ms, grads[1][1][name][1]):
            assert torch.equal(a, b), name


def test_cli_trains_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train as cli
    ck = str(tmp_path / "cli.npz")
    assert cli.main(["--device", "cpu", "--reduced", "--steps", "2",
                     "--batch", "2", "--seq", "16", "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "tokens/s" in out and ck in out


@pytest.mark.parametrize("flag", [["--devices", "4", "--mesh", "3,1"],
                                  ["--devices", "2", "--mesh", "2,2"]])
def test_cli_refuses_multi_device(flag):
    """A mesh whose size is not ``--devices`` is refused before any rank
    starts (``--devices`` / ``--mesh`` run: test_torch_sharding.py)."""
    from repro_torch.launch import train as cli
    with pytest.raises(ValueError, match="--mesh"):
        cli.main(["--device", "cpu", "--reduced"] + flag)


def test_entry_points_refuse_without_a_card():
    """The entry points default to the card and refuse on a host without
    one rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        train(get_reduced("smollm-360m"), n_steps=1, batch=1, seq=8)


def test_examples_run_on_the_cpu(capsys, tmp_path):
    from repro_torch.examples import quantize_with_awq, train_small
    train_small.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                      "--seq", "16", "--checkpoint",
                      str(tmp_path / "small.npz")])
    quantize_with_awq.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "loss" in out and "AWQ-W4" in out
