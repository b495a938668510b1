"""The port's accounting equals the JAX package's, integer for integer.

Same configurations and same numpy inputs through ``repro`` and
``repro_torch``: ``attn_free`` / ``param_count`` / ``active_param_count``
of all ten architectures, full and REDUCED; ``SHAPES`` and
``all_configs``; ``PackedWeight.storage_bytes`` in every layout and for a
stack; ``FormatSpec.bytes_per_value`` and ``PrecisionPolicy.weight_bytes``
for every policy; ``kv_bytes`` of every family's decode state and of the
paged pool, where the port holds fewer bytes by exactly the reference's
leaves it does not keep (``core/paged_kvcache.kv_bytes``): the slabs'
``(L, B)`` int32 ``length`` and the pool's per-layer copies of its block
table and ``length``.  Tolerance: none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
import repro.core as JCORE
from repro.core import packing as JP
from repro.core import paged_kvcache as JPKV
from repro.core import precision as JPR
from repro.models import transformer as JT
from repro.models.registry import build as j_build
import repro_torch.configs as TCFG
from repro_torch.configs.base import jax_fields
import repro_torch.core as TCORE
from repro_torch.core import packing as TP
from repro_torch.core import paged_kvcache as TPKV
from repro_torch.core import precision as TPR
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build as t_build
from repro_torch.serving import Engine, EngineConfig
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

KV_FORMATS = ("kv4", "kv8", "kvfp8", "kv16")


@pytest.mark.parametrize("arch", TCFG.ARCHS)
def test_param_counts_equal_jax(arch):
    for t_get, j_get in ((TCFG.get_config, JCFG.get_config),
                         (TCFG.get_reduced, JCFG.get_reduced)):
        ct, cj = t_get(arch), j_get(arch)
        assert ct.attn_free == cj.attn_free
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
        assert isinstance(ct.param_count(), int)


def test_shapes_and_all_configs_equal_jax():
    assert TCFG.SHAPES == JCFG.SHAPES
    t_all, j_all = TCFG.all_configs(), JCFG.all_configs()
    assert list(t_all) == list(j_all) == TCFG.ARCHS
    for arch in TCFG.ARCHS:
        assert jax_fields(t_all[arch]) == dataclasses.asdict(j_all[arch])


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group", [64, 128])
def test_storage_bytes_equal_jax_in_every_layout(bits, group):
    """The tile layout and both fragment layouts hold K·N·bits/8 bytes of
    values and (K/group)·N f32 scales."""
    K, N = 256, 384
    w = np.random.default_rng(bits + group).standard_normal(
        (K, N)).astype(np.float32)
    pj = JP.pack_weight(jnp.asarray(w), bits=bits, group=group)
    pt = TP.pack_weight(torch.from_numpy(w), bits=bits, group=group)
    want = K * N * bits // 8 + (K // group) * N * 4
    assert pj.storage_bytes == pt.storage_bytes == want
    for kernel in ("a16", "a8"):
        frag = TP.to_kernel_layout(pt, kernel)
        assert frag.layout != pt.layout
        assert frag.storage_bytes == want


def test_storage_bytes_of_a_stack_equal_jax():
    w = np.random.default_rng(3).standard_normal(
        (3, 256, 384)).astype(np.float32)
    pj = jax.vmap(lambda m: JP.pack_weight(m, bits=4, group=64, block_k=64,
                                           block_n=128))(jnp.asarray(w))
    pt = TP.pack_stack(torch.from_numpy(w), bits=4, group=64, block_k=64,
                       block_n=128)
    assert pt.storage_bytes == pj.storage_bytes == \
        3 * pt[0].storage_bytes


def _policies():
    """Every WxAyKVz the parser (and so the engine) accepts, and the
    aliases."""
    names = [w + a + kv for w in JPR._WEIGHT_FORMATS
             for a in JPR._ACT_FORMATS for kv in JPR._KV_FORMATS]
    return names + list(JPR._ALIASES) + [None]


@pytest.mark.parametrize("weights", ["w4", "w8", "wfp8", "w16"])
def test_bytes_per_value_and_weight_bytes_equal_jax(weights):
    names = [n for n in _policies() if n is None or
             JPR.get_policy(n).weights.name == weights]
    assert names
    for name in names:
        pj, pt = JPR.get_policy(name), TPR.get_policy(name)
        for atom in ("weights", "acts", "kv"):
            assert getattr(pt, atom).bytes_per_value == \
                getattr(pj, atom).bytes_per_value
        for n in (0, 1, 7, 4096 * 4096, 10 ** 9 + 3):
            assert pt.weight_bytes(n) == pj.weight_bytes(n)


def _leaf_bytes(tree, *names):
    """Bytes of a JAX pytree's leaves whose path ends in one of
    ``names``."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if str(path[-1]).lstrip(".") in names:
            total += leaf.size * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", TCFG.ARCHS)
def test_decode_state_bytes_equal_jax_less_length(arch):
    """Every family's slab or recurrent state: the port's kv_bytes is the
    reference's less its int32 ``length`` leaves, 4·B a slab layer (0 for
    rwkv6's state, which has none)."""
    B = 3
    cj = j_build(JCFG.get_reduced(arch)).init_cache(
        JPR.get_policy("w4a16kv8"), B, 64)
    ct = t_build(TCFG.get_reduced(arch)).init_cache(
        TPR.get_policy("w4a16kv8"), B, 64, "cpu")
    gap = _leaf_bytes(cj, "length")
    assert TPKV.kv_bytes(ct) == JPKV.kv_bytes(cj) - gap
    if arch == "smollm-360m":
        assert gap == 4 * TCFG.get_reduced(arch).n_layers * B


@pytest.mark.parametrize("fmt", KV_FORMATS)
def test_pool_and_slab_bytes_in_every_kv_format(fmt):
    """REDUCED smollm: the pool (+ scales + one block table) is the
    reference's less its other L − 1 tables and its (L, n_slots) length;
    the slab the reference's less 4·L·B; the pools and scales themselves
    the same bytes."""
    cfg_j = JCFG.get_reduced("smollm-360m")
    cfg_t = TCFG.get_reduced("smollm-360m")
    pj, pt = JPR.get_policy(f"w4a16{fmt}"), TPR.get_policy(f"w4a16{fmt}")
    L, n_slots, n_blocks, bs, bps = cfg_t.n_layers, 3, 10, 8, 4
    poolj = JT.init_paged_cache(cfg_j, pj, n_slots, n_blocks, bs, bps)
    poolt = TT.init_paged_cache(cfg_t, pt, n_slots, n_blocks, bs, bps,
                                device="cpu")
    table = n_slots * bps * 4
    assert TPKV.kv_bytes(poolt) == \
        JPKV.kv_bytes(poolj) - (L - 1) * table - 4 * L * n_slots
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(poolt, name)
        assert t.numel() * t.element_size() == _leaf_bytes(poolj, name)
    slabj = JT.init_cache(cfg_j, pj, n_slots, bps * bs)
    slabt = TT.init_cache(cfg_t, pt, n_slots, bps * bs, device="cpu")
    assert TPKV.kv_bytes(slabt) == JPKV.kv_bytes(slabj) - 4 * L * n_slots


@pytest.mark.parametrize("arch,kind", [("smollm-360m", "dense"),
                                       ("smollm-360m", "paged"),
                                       ("rwkv6-7b", "dense")])
def test_engine_reports_kv_bytes(arch, kind):
    eng = Engine(EngineConfig(model=TCFG.get_reduced(arch), n_slots=2,
                              max_seq=64, block_size=8, cache_kind=kind,
                              device="cpu"))
    assert eng.kv_resident_bytes() == TPKV.kv_bytes(eng.cache) > 0


def test_core_surface_matches_jax():
    """Every public name of ``repro.core`` — the dry-run's ``cache_spec``
    too, since the dry-run is ported — resolves in ``repro_torch.core``,
    in ``__all__``, in the reference's order."""
    want = list(JCORE.__all__)
    assert TCORE.__all__ == want
    for name in want:
        assert getattr(TCORE, name) is not None
