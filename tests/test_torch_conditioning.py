"""Structured conditioning in the port against the JAX package, on the CPU
in f32: `crop_to_tile` in every branch, `prep_cond_for_tiles` and
`tile_cond` over a 2x2 grid, `composite_eps` with two entries, a mask
and a timestep window (sigma at each edge of the window), the batching
rule of the CFG pair, and each conditioning node.

Inputs are numpy-seeded and go to both packages as the same arrays.
Tolerances: resizes build their weights in f64 here and in f32 in JAX
(~1e-7 a weight, up to 2.5e-6 measured on a pixel: 5e-6); everything
else is exact or f32 summation order (2e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_controlnet as jnodes
from comfyui_distributed_tpu.graph import nodes_core as jcore
from comfyui_distributed_tpu.ops import conditioning as jcond
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.ops import tiles as jtiles
from comfyui_distributed_tpu.ops import upscale as jup
from comfyui_distributed_tpu_torch.graph import nodes_controlnet as tnodes
from comfyui_distributed_tpu_torch.graph import nodes_core as tcore
from comfyui_distributed_tpu_torch.ops import conditioning as tcond
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops import tiles as ttiles
from comfyui_distributed_tpu_torch.ops import upscale as tup

TENSORS = ("context", "pooled", "control_hint", "mask", "gligen_embs")
STATICS = ("control_strength", "area", "control_range", "strength", "timestep_range",
           "size_cond", "gligen_boxes", "gligen_active")


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(**arrays):
    """(JAX Conditioning, port Conditioning) over the same numpy arrays;
    non-array values pass to both as they are."""
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}
    return jcond.Conditioning(**jkw), tcond.Conditioning(**tkw)


def _fields(cond):
    out = {name: getattr(cond, name) for name in STATICS}
    for name in TENSORS:
        value = getattr(cond, name)
        out[name] = None if value is None else np.asarray(value)
    return out


def assert_same(tc, jc, atol=0.0):
    """Every field the port carries equal to the JAX entry's: statics
    exactly, tensors within `atol`."""
    t, j = _fields(tc), _fields(jc)
    for name in STATICS:
        assert t[name] == j[name], name
    for name in TENSORS:
        assert (t[name] is None) == (j[name] is None), name
        if t[name] is not None:
            assert t[name].shape == j[name].shape, name
            np.testing.assert_allclose(t[name], j[name], atol=atol, rtol=0, err_msg=name)


def _assert_same_value(tv, jv, atol=0.0):
    if isinstance(jv, (list, tuple)):
        assert isinstance(tv, (list, tuple)) and len(tv) == len(jv)
        for t, j in zip(tv, jv):
            assert_same(t, j, atol)
    else:
        assert_same(tv, jv, atol)


# --- crop_to_tile ---------------------------------------------------------------

IMAGE_HW = (48, 56)
TILE_HW = (32, 24)
ORIGINS = [(-8, -8), (0, 16), (24, 40), (16, -4)]


@pytest.mark.parametrize("hint_hw", [IMAGE_HW, (24, 40)], ids=["at image size", "resized"])
@pytest.mark.parametrize("y, x", ORIGINS)
def test_crop_to_tile_windows_a_hint_and_a_mask(hint_hw, y, x):
    """The hint and the mask resized (linear) to the frame where their
    size differs, edge-extended past it, windowed at the tile."""
    rng = _rng(1)
    jc, tc = _pair(context=rng.standard_normal((1, 4, 8), dtype=np.float32),
                   control_hint=rng.random((1, *hint_hw, 3), dtype=np.float32),
                   mask=rng.random((1, *hint_hw), dtype=np.float32))
    args = (y, x, *TILE_HW, *IMAGE_HW)
    got, ref = tcond.crop_to_tile(tc, *args), jcond.crop_to_tile(jc, *args)
    assert tuple(got.control_hint.shape) == (1, *TILE_HW, 3)
    assert tuple(got.mask.shape) == (1, *TILE_HW)
    assert_same(got, ref, atol=5e-6)
    assert got.control_hint is not tc.control_hint  # the entry itself is not changed


@pytest.mark.parametrize("area, expected", [
    ((16, 16, 8, 8), None),                          # inside the tile at (0, 0)
    (("percentage", 0.5, 0.5, 0.25, 0.25), None),    # a fraction of the frame
    ((8, 8, 40, 48), "vanished"),                    # off the tile
    ((40, 60, -8, -8), None),                        # beyond the frame
])
def test_crop_to_tile_intersects_an_area(area, expected):
    jc, tc = _pair(context=np.zeros((1, 4, 8), np.float32), area=area)
    got, ref = (mod.crop_to_tile(c, 0, 0, *TILE_HW, *IMAGE_HW)
                for mod, c in ((tcond, tc), (jcond, jc)))
    assert_same(got, ref)
    if expected == "vanished":
        assert got.area is None and got.control_strength == 0.0
    else:
        assert got.area is not None and got.control_strength == 1.0


def test_resolve_area_matches_jax():
    for area in [None, (8, 16, 0, 8), ("percentage", 0.5, 0.25, 0.1, 0.3)]:
        assert tcond.resolve_area(area, 48, 56) == jcond.resolve_area(area, 48, 56)


@pytest.mark.parametrize("y, x", ORIGINS)
def test_crop_to_tile_marks_gligen_boxes_off_the_tile_inactive(y, x):
    boxes = ((2, 2, 0, 0), (3, 1, 4, 6), (1, 1, 5, 6), (2, 4, 1, 1))
    jc, tc = _pair(context=np.zeros((1, 4, 8), np.float32),
                   gligen_embs=_rng(2).standard_normal((4, 8), dtype=np.float32),
                   gligen_boxes=boxes)
    got = tcond.crop_to_tile(tc, y, x, *TILE_HW, *IMAGE_HW)
    assert_same(got, jcond.crop_to_tile(jc, y, x, *TILE_HW, *IMAGE_HW))
    assert len(got.gligen_active) == len(boxes)


def test_slice_batch_matches_jax():
    rng = _rng(3)
    jc, tc = _pair(context=rng.standard_normal((4, 3, 8), dtype=np.float32),
                   control_hint=rng.random((1, 8, 8, 3), dtype=np.float32),
                   mask=rng.random((4, 8, 8), dtype=np.float32))
    assert_same(tcond.slice_batch(tc, 1, 2), jcond.slice_batch(jc, 1, 2))


def test_map_conditioning_clones_every_entry():
    entries = [tcond.Conditioning(context=torch.zeros(1, 2, 3)) for _ in range(2)]

    def patch(c):
        c.strength = 0.5
        return c

    out = tcond.map_conditioning(entries, patch)
    assert [e.strength for e in out] == [0.5, 0.5]
    assert [e.strength for e in entries] == [1.0, 1.0]


def test_clone_shares_the_controlnet_module():
    net = torch.nn.Linear(2, 2)
    cond = tcond.Conditioning(context=torch.zeros(1, 1, 2), control_net=net)
    assert cond.clone().control_net is net


def test_an_unported_field_is_refused_naming_its_item():
    cond = tcond.Conditioning(context=torch.zeros(1, 1, 2))
    cond.model_patches = {"patch": torch.zeros(1, 2, 2, 4)}  # no node sets it
    with pytest.raises(NotImplementedError, match="'model_patches' is not supported"):
        tsmp.cfg_model(lambda x, s, c: x, 2.0)(torch.zeros(1, 2, 2, 4), torch.ones(1),
                                                (cond, tcond.Conditioning(torch.zeros(1, 1, 2))))


# --- prep_cond_for_tiles / tile_cond ------------------------------------------------

def test_prep_and_tile_cond_window_hint_and_mask_over_a_2x2_grid():
    rng = _rng(4)
    jc, tc = _pair(context=rng.standard_normal((1, 4, 8), dtype=np.float32),
                   control_hint=rng.random((1, 40, 36, 3), dtype=np.float32),
                   mask=rng.random((1, 20, 30), dtype=np.float32))
    jgrid = jtiles.calculate_tiles(64, 64, 32, 32, 8)
    tgrid = ttiles.calculate_tiles(64, 64, 32, 32, 8)
    jprep, tprep = jup.prep_cond_for_tiles(jc, jgrid), tup.prep_cond_for_tiles(tc, tgrid)
    assert tgrid.num_tiles == 4
    for y, x in tgrid.positions:
        got = tup.tile_cond(tprep, y, x, tgrid)
        assert tuple(got.control_hint.shape) == (1, 48, 48, 3)
        assert_same(got, jup.tile_cond(jprep, y, x, jgrid), atol=5e-6)


def test_prep_cond_for_tiles_preps_every_entry_and_refuses_an_area():
    jc, tc = _pair(context=np.zeros((1, 4, 8), np.float32),
                   mask=_rng(5).random((1, 16, 16), dtype=np.float32))
    tgrid = ttiles.calculate_tiles(32, 32, 16, 16, 8)
    prepped = tup.prep_cond_for_tiles([tc, tc], tgrid)
    jprepped = jup.prep_cond_for_tiles([jc, jc], jtiles.calculate_tiles(32, 32, 16, 16, 8))
    _assert_same_value(prepped, jprepped, atol=5e-6)
    area = tcond.Conditioning(context=torch.zeros(1, 4, 8), area=(8, 8, 0, 0))
    with pytest.raises(ValueError, match="area-restricted"):
        tup.prep_cond_for_tiles(area, tgrid)
    with pytest.raises(ValueError, match="area-restricted"):
        jup.prep_cond_for_tiles(jcond.Conditioning(context=jnp.zeros((1, 4, 8)), area=(8, 8, 0, 0)),
                                jtiles.calculate_tiles(32, 32, 16, 16, 8))


# --- composite_eps -----------------------------------------------------------------

def _toy_model(x, sigma, cond):
    """eps depending on the latents, sigma and the entry's context: a
    crop sees its own values."""
    ctx = cond.context
    scale = ctx.mean() if hasattr(ctx, "mean") else ctx
    return x * scale + 0.1 * sigma.reshape((-1,) + (1,) * (x.ndim - 1)) + ctx[..., 0].sum()


def _window_edges(window):
    """sigma at each edge of a progress window, and one f32 step past it."""
    hi = np.float32(jsmp.percent_to_sigma(window[0], "eps"))
    lo = np.float32(jsmp.percent_to_sigma(window[1], "eps"))
    return [hi, np.nextafter(hi, np.float32(np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]


WINDOW = (0.25, 0.6)


@pytest.mark.parametrize("edge", range(4), ids=["top", "above top", "bottom", "above bottom"])
def test_composite_eps_follows_jax_at_each_edge_of_the_window(edge):
    """Two entries, one masked and windowed, one over a pixel area, one
    over a percentage area: the same composite as the JAX package's at
    sigma on each edge of the window (<= at the top, > at the bottom)
    and one f32 step beyond."""
    sigma = _window_edges(WINDOW)[edge]
    rng = _rng(6)
    x = rng.standard_normal((1, 6, 8, 4), dtype=np.float32)
    mask = rng.random((1, 24, 32), dtype=np.float32)
    specs = [
        dict(context=rng.standard_normal((1, 3, 5), dtype=np.float32), mask=mask,
             timestep_range=WINDOW, strength=0.7),
        dict(context=rng.standard_normal((1, 3, 5), dtype=np.float32), area=(24, 40, 8, 16)),
        dict(context=rng.standard_normal((1, 3, 5), dtype=np.float32),
             area=("percentage", 0.5, 0.5, 0.5, 0.25), strength=1.5),
    ]
    jentries, tentries = zip(*(_pair(**s) for s in specs))
    sig = np.full((1,), sigma, np.float32)
    ref = np.asarray(jsmp.composite_eps(_toy_model, jnp.asarray(x), jnp.asarray(sig),
                                        list(jentries)))
    got = tsmp.composite_eps(_toy_model, torch.from_numpy(x), torch.from_numpy(sig),
                             list(tentries))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)
    inside = edge in (0, 3)
    assert tsmp.in_window(torch.from_numpy(sig), WINDOW) is inside


def test_percent_to_sigma_matches_jax():
    for p in (0.0, 0.1, 0.25, 0.5, 0.999, 1.0):
        for param in ("eps", "v"):
            assert tsmp.percent_to_sigma(p, param) == jsmp.percent_to_sigma(p, param)


def test_a_conditioning_list_takes_the_per_entry_path_in_cfg():
    rng = _rng(7)
    x = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    specs = [dict(context=rng.standard_normal((1, 3, 5), dtype=np.float32)) for _ in range(3)]
    (j1, t1), (j2, t2), (jn, tn) = (_pair(**s) for s in specs)
    sig = np.full((1,), 3.0, np.float32)
    ref = jsmp.cfg_model(_toy_model, 5.0)(jnp.asarray(x), jnp.asarray(sig), ([j1, j2], jn))
    got = tsmp.cfg_model(_toy_model, 5.0)(torch.from_numpy(x), torch.from_numpy(sig),
                                          ([t1, t2], tn))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=0)


@pytest.mark.parametrize("change, batchable", [
    ({}, True),
    ({"size_cond": (64, 64, 0, 0, 64, 64)}, False),
    ({"control_net": "a ControlNet"}, False),
    ({"mask": "shape"}, False),
])
def test_the_cfg_pair_batches_by_the_jax_packages_rule(change, batchable):
    """Only structurally equal entries without a ControlNet ride one pass;
    the batched entry carries every tensor field."""
    rng = _rng(8)
    base = dict(context=rng.standard_normal((1, 3, 5), dtype=np.float32),
                pooled=rng.standard_normal((1, 6), dtype=np.float32),
                size_cond=(32, 32, 0, 0, 32, 32))
    pos = tcond.Conditioning(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                for k, v in base.items()})
    neg = pos.clone()
    neg.context = pos.context + 1.0
    for name, value in change.items():
        if value == "shape":
            pos.mask, neg.mask = torch.ones(1, 4, 4), torch.ones(1, 8, 8)
        else:
            setattr(neg, name, value)
    assert tsmp._conds_batchable(pos, neg) is batchable
    if batchable:
        both = tcond.concat_batch(pos, neg)
        assert both.size_cond == pos.size_cond and both.context.shape[0] == 2
        assert torch.equal(both.pooled, torch.cat([pos.pooled, neg.pooled]))


# --- the conditioning nodes -----------------------------------------------------------

def _node_inputs(seed):
    rng = _rng(seed)
    a = dict(context=rng.standard_normal((1, 4, 6), dtype=np.float32),
             pooled=rng.standard_normal((1, 5), dtype=np.float32))
    b = dict(context=rng.standard_normal((1, 6, 6), dtype=np.float32),
             pooled=rng.standard_normal((1, 5), dtype=np.float32))
    return _pair(**a), _pair(**b), rng.random((1, 16, 16), dtype=np.float32)


NODE_CASES = {
    "ConditioningSetArea": ("set_area", lambda a, b, m: ((a,), dict(width=32, height=16, x=8,
                                                                   y=0, strength=0.5))),
    "ConditioningSetAreaPercentage": ("set_area", lambda a, b, m: (
        (a,), dict(width=0.5, height=0.25, x=0.1, y=0.2, strength=2.0))),
    "ConditioningCombine": ("combine", lambda a, b, m: ((a, b), {})),
    "ConditioningAverage": ("average", lambda a, b, m: ((a, b), dict(
        conditioning_to_strength=0.3))),
    "ConditioningAverage, shorter to": ("average", lambda a, b, m: ((b, a), dict(
        conditioning_to_strength=0.6))),
    "ConditioningZeroOut": ("zero_out", lambda a, b, m: ((a,), {})),
    "ConditioningSetTimestepRange": ("set_range", lambda a, b, m: ((a,), dict(start=0.2,
                                                                              end=0.7))),
    "ConditioningSetMask": ("set_mask", lambda a, b, m: ((a, m), {})),
    "ConditioningConcat": ("concat", lambda a, b, m: ((a, b), {})),
}


@pytest.mark.parametrize("case", list(NODE_CASES))
@pytest.mark.parametrize("listed", [False, True], ids=["one entry", "a combined list"])
def test_each_conditioning_node_matches_jax(case, listed):
    node_name = case.split(",")[0]
    method, make = NODE_CASES[case]
    (ja, ta), (jb, tb), mask = _node_inputs(9)
    jargs, kwargs = make(ja, jb, jnp.asarray(mask))
    targs, _ = make(ta, tb, torch.from_numpy(mask))
    if listed:  # the first input a ConditioningCombine output
        jargs = ([jargs[0], jb],) + tuple(jargs[1:])
        targs = ([targs[0], tb],) + tuple(targs[1:])
    jmod = jcore if node_name == "ConditioningConcat" else jnodes
    tmod = tcore if node_name == "ConditioningConcat" else tnodes
    (ref,) = getattr(getattr(jmod, node_name)(), method)(*jargs, **kwargs)
    (got,) = getattr(getattr(tmod, node_name)(), method)(*targs, **kwargs)
    _assert_same_value(got, ref, atol=1e-6)


def test_set_timestep_range_rejects_out_of_range_percents():
    (_, ta), _, _ = _node_inputs(10)
    with pytest.raises(ValueError, match="percents"):
        tnodes.ConditioningSetTimestepRange().set_range(ta, start=-0.1, end=0.5)
