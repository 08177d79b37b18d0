"""The port's non-fused inter path against the JAX package's host path.

With the interpolation-filter search or the inter tx-type sweep on
(presets 0 and 1), the JAX package codes each shape group through
``_encode_blocks``: ME + RD and compound on its device, then the filter
search (``_interp_filter_select``), the winner predictions and
``md.inter_tx_search`` and chroma with the per-block filter on the host.
The port runs all of it on its device (``ops/device_inter.py`` stages).
Checked on the CPU, tolerance 0 throughout (the pixel path is integer):

- the luma stages (``me_rd_j``, ``compound_j``) against the host
  ``_me_rd_pruned`` and ``_compound_pairs``;
- per-lane filter-type MC (``mc_block_batch_j``, ``mc_block_batch_conv_j``)
  against the host ``mc.mc_block_batch`` / ``mc_block_batch_conv``;
- ``inter_tx_search_j`` against ``md.inter_tx_search``;
- ``interp_filter_select_j`` against ``_interp_filter_select`` on one
  shape group with compound blocks;
- whole streams against the JAX host encoder, with the port's recon equal
  to the JAX mirror decoder's decode of its stream.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.ops import mc as jmc
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.pipeline import common as jcommon
from svt_av1_tpu.pipeline import inter as jinter
from svt_av1_tpu.pipeline import md as jmd
from svt_av1_tpu.pipeline import rd as jrd
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops import device as tdev
from svt_av1_tpu_torch.ops import device_inter as tdi
from svt_av1_tpu_torch.pipeline import inter as tinter
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.test_torch_directional import (assert_decodes_to,
                                          encode_with_recons)
from tests.test_torch_inter_encode import _scene_change_pair
from tests.torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    np.testing.assert_array_equal(got, np.asarray(want))


def _mc_lanes(rng, plane_hw, w, h, ss, b):
    """Block positions over a plane and MVs from the clamp bounds (both
    extremes, so windows reach the padded border) and random ones."""
    ph, pw = plane_hw
    xs = rng.integers(0, pw - w + 1, b)
    ys = rng.integers(0, ph - h + 1, b)
    xs[:2], ys[:2] = 0, 0
    xs[2:4], ys[2:4] = pw - w, ph - h
    mvs = rng.integers(-200, 200, (b, 2))
    mvs[0] = mvs[2] = (-100000, -100000)
    mvs[1] = mvs[3] = (100000, 100000)
    mvs = np.array([jmc.clamp_mv_for_padding(m, x, y, w, h, pw, ph, ss)
                    for m, x, y in zip(mvs, xs, ys)], np.int64)
    return xs.astype(np.int64), ys.astype(np.int64), mvs


# (w, h, ss, bd): 4- to 64-px dimensions (4 px takes the 4-tap bank)
MC_CASES = [(4, 4, 1, 8), (4, 8, 1, 8), (8, 4, 1, 10), (8, 8, 0, 8),
            (16, 8, 1, 8), (16, 16, 0, 10), (32, 16, 0, 8),
            (64, 64, 0, 8), (32, 32, 1, 10)]


@pytest.mark.parametrize("w,h,ss,bd", MC_CASES)
def test_mc_per_lane_ftype_matches_host(w, h, ss, bd):
    """Mixed per-lane filters, two references in one stacked bank."""
    rng = np.random.default_rng(w * 100 + h + ss + bd)
    plane_hw = (48, 80) if ss else (96, 160)
    refs = [jmc.pad_reference(rng.integers(0, 1 << bd, plane_hw)
                              .astype(np.uint16 if bd > 8 else np.uint8))
            for _ in range(2)]
    b = 24
    xs, ys, mvs = _mc_lanes(rng, plane_hw, w, h, ss, b)
    ft = rng.integers(0, 3, b).astype(np.int32)
    ridx = rng.integers(0, 2, b)
    bank = _t(np.stack(refs).astype(np.int32)).to(
        torch.int16 if bd > 8 else torch.uint8)
    args = (bank, _t(xs), _t(ys), _t(mvs), w, h)
    got = tdev.mc_block_batch_j(*args, ss=ss, bd=bd, ref_idx=_t(ridx),
                                ftype=_t(ft))
    got_c = tdi.mc_block_batch_conv_j(*args, ss=ss, bd=bd, ref_idx=_t(ridx),
                                      ftype=_t(ft))
    want = np.zeros((b, h, w), np.int64)
    want_c = np.zeros((b, h, w), np.int64)
    for r in range(2):
        m = ridx == r
        want[m] = jmc.mc_block_batch(refs[r], xs[m], ys[m], mvs[m], w, h,
                                     ss=ss, bd=bd, ftype=ft[m])
        want_c[m] = jmc.mc_block_batch_conv(refs[r], xs[m], ys[m], mvs[m],
                                            w, h, ss=ss, bd=bd, ftype=ft[m])
    _eq(got, want)
    _eq(got_c, want_c)
    # no ftype and ftype 0 are today's REGULAR integers; a scalar ftype
    # equals the per-lane one
    reg = tdev.mc_block_batch_j(*args, ss=ss, bd=bd, ref_idx=_t(ridx))
    _eq(tdev.mc_block_batch_j(*args, ss=ss, bd=bd, ref_idx=_t(ridx),
                              ftype=_t(np.zeros(b, np.int32))), reg)
    _eq(tdev.mc_block_batch_j(*args, ss=ss, bd=bd, ref_idx=_t(ridx),
                              ftype=2),
        tdev.mc_block_batch_j(*args, ss=ss, bd=bd, ref_idx=_t(ridx),
                              ftype=_t(np.full(b, 2, np.int32))))
    if min(w, h) > 4:      # the three banks differ at these sizes
        assert not torch.equal(got, reg)


@pytest.mark.parametrize("size,ref_sel", [(16, True), ((32, 16), True),
                                          (8, True), (16, False)])
def test_luma_stages_match_host_me_rd_and_compound(size, ref_sel):
    """``me_rd_j`` + ``compound_j`` (the luma half of the shape group)
    against the JAX host ``_me_rd_pruned``, ``_compound_pairs`` and the
    compound fold of ``_encode_blocks``. References: frames 0 and 2 of a
    clip and a flat plane (the searches tie against it); without
    ``ref_sel`` only the two forward ones (low delay)."""
    from svt_av1_tpu.entropy.inter_modes import ALTREF_FRAME, GOLDEN_FRAME
    from svt_av1_tpu.ops import me as jme
    w, h = 128, 64
    frames = make_clip(w=w, h=h, frames=3, seed=5)
    src = jcommon.pad_frame_planes(*frames[1], dtype=np.int32)
    flat = [np.full(p.shape, 128, np.uint8) for p in frames[0]]
    ids = (1, GOLDEN_FRAME) + ((ALTREF_FRAME,) if ref_sel else ())
    planes = dict(zip((1, GOLDEN_FRAME, ALTREF_FRAME),
                      (frames[0], flat, frames[2])))
    refs = {r: [jmc.pad_reference(np.asarray(p)) for p in planes[r]]
            for r in ids}
    order = sorted(refs)
    host = SimpleNamespace(
        cfg=JaxConfig(width=w, height=h), refs=refs,
        ref_pyrs={r: jme.build_pyramid(refs[r][0]) for r in order},
        src=src, src_pyr=jme.src_pyramid(src[0]),
        fwd_refs=[r for r in order if r < ALTREF_FRAME],
        bwd_refs=[r for r in order if r >= ALTREF_FRAME])
    host.reference_select = bool(host.fwd_refs and host.bwd_refs)
    bw, bh = jcommon.leaf_wh(size)
    gx, gy = np.meshgrid(np.arange(0, w, bw), np.arange(0, h, bh))
    xs, ys = gx.reshape(-1).astype(np.int64), gy.reshape(-1).astype(np.int64)
    b = len(xs)
    srcs = np.stack([src[0][y:y + bh, x:x + bw]
                     for x, y in zip(xs, ys)]).astype(np.int64)
    qidx = 100
    qp = jquant.make_quant_params(qidx)
    lam = jrd.rd_lambda(qidx, 8)
    tx_size = jcommon.tx_size_for_rect(bw, bh, 0)
    chosen_ref, chosen, pmvs, fsel, bsel = \
        jinter.InterFrameEncoder._me_rd_pruned(
            host, xs, ys, srcs, (bw, bh), tx_size, qp, lam, order)
    comp = np.zeros(b, bool)
    mv1 = np.zeros((b, 2), np.int64)
    if ref_sel:
        comp_f = np.full(b, 1, np.int32)
        comp_b = np.zeros(b, np.int32)
        cost, qc, eo, rec, mv0a, mv1a = \
            jinter.InterFrameEncoder._compound_pairs(
                host, fsel, bsel, pmvs, xs, ys, srcs, (bw, bh), tx_size, qp,
                lam, comp_f, comp_b)
        comp = cost < chosen[0]
        for k, v in enumerate((cost, mv0a, qc, eo, rec)):
            chosen[k] = np.where(comp.reshape((b,) + (1,) * (v.ndim - 1)),
                                 v, chosen[k])
        chosen_ref = np.where(comp, comp_f, chosen_ref)
        mv1 = np.where(comp[:, None], mv1a, 0)
        assert comp.any() and not comp.all()
    u8 = (lambda a: _t(np.asarray(a)).to(torch.uint8))
    pos = {r: i for i, r in enumerate(order)}
    fwd = tuple(pos[r] for r in host.fwd_refs) if ref_sel else ()
    bwd = tuple(pos[r] for r in host.bwd_refs) if ref_sel else ()
    args = (_t(xs), _t(ys), size, _t(np.full(b, qidx, np.int32)),
            _t(np.full(b, jmd.lam_to_q(lam), np.int64)))
    g = tdi.me_rd_j([tuple(u8(p) for p in host.ref_pyrs[r]) for r in order],
                    tuple(u8(p) for p in host.src_pyr), *args, fwd, bwd, 8,
                    rdoq=True)
    tdi.compound_j(g, *args, 8, rdoq=True)
    _eq(np.asarray(order)[g["pos"].numpy()], chosen_ref)
    _eq(g["comp"], comp)
    _eq(g["mv1"], mv1)
    for k, name in enumerate(("cost", "mv", "qc", "eo", "rec")):
        _eq(g[name], chosen[k])


def _tx_inputs(size, qidx, rdoq, seed):
    """Sources, predictions and the host's DCT state of one group."""
    rng = np.random.default_rng(seed)
    b = 12
    srcs = rng.integers(0, 256, (b, size, size)).astype(np.int64)
    preds = np.clip(srcs + rng.integers(-40, 40, (b, size, size)),
                    0, 255).astype(np.int64)
    preds[:3] = srcs[:3] // 2 + 60          # large residuals
    tx_size = jcommon.tx_size_for_rect(size, size, 0)
    qp = jquant.make_quant_params(qidx)
    lam = jrd.rd_lambda(qidx, 8)
    lamq = jmd.lam_to_q(lam)
    qc, eo, rec, dist, rate = jmd._full_loop(
        srcs, preds, np.zeros(b, np.int32), tx_size, (size, size), qp, 8,
        rdoq_lam_q=lamq if (rdoq and qidx > 0) else None)
    cost = jmd.rdcost(dist, lamq, rate + (2 << jmd.RATE_Q))
    return srcs, preds, [cost, qc, eo, rec], tx_size, qp, lam


@pytest.mark.parametrize("size,qidx,rdoq", [
    (8, 100, True), (8, 160, False), (16, 100, True), (16, 60, False),
    (32, 120, True), (16, 0, True)])
def test_inter_tx_search_matches_host(size, qidx, rdoq):
    srcs, preds, st, tx_size, qp, lam = _tx_inputs(size, qidx, rdoq,
                                                   size + qidx)
    b = len(srcs)
    g = {"srcs": _t(srcs), "pred": _t(preds), "cost": _t(st[0]),
         "qc": _t(st[1]), "eo": _t(st[2].astype(np.int64)), "rec": _t(st[3])}
    qv = _t(np.full(b, qidx, np.int32))
    lamqv = _t(np.full(b, jmd.lam_to_q(lam), np.int64))
    tdi.inter_tx_search_j(g, (size, size), qv, 8, lamqv, rdoq)
    want = jmd.inter_tx_search(srcs, preds, *st, tx_size, (size, size), qp,
                               8, lam, rdoq=rdoq)
    _eq(g["tts"], want)
    for k, name in enumerate(("cost", "qc", "eo", "rec")):
        _eq(g[name], st[k])
    if qidx == 0:
        assert not want.any()
    else:
        assert (want != 0).any()       # the sweep moves some blocks


def _host_chroma(refs, src_c, plane, xs, ys, size, mv0, mv1, chosen_ref,
                 comp, comp_b, ftype, ctts, qp, lam):
    """The chroma tail of the JAX host ``_encode_blocks`` for one plane:
    MC per reference (or the compound pair) with the blocks' filters, then
    the full loop with the inherited tx types and plane_type 1."""
    cw = ch = size // 2
    cxs, cys = xs >> 1, ys >> 1
    srcs = np.stack([src_c[y:y + ch, x:x + cw]
                     for x, y in zip(cxs, cys)]).astype(np.int64)
    pred = np.zeros((len(xs), ch, cw), np.int64)
    for ref in np.unique(chosen_ref):
        m = (chosen_ref == ref) & ~comp
        pred[m] = jmc.mc_block_batch(refs[ref][plane], cxs[m], cys[m],
                                     mv0[m], cw, ch, ss=1, ftype=ftype[m])
    for ref in np.unique(chosen_ref[comp]):
        m = (chosen_ref == ref) & comp
        sides = [jmc.mc_block_batch_conv(refs[r][plane], cxs[m], cys[m],
                                         mv[m], cw, ch, ss=1,
                                         ftype=ftype[m])
                 for r, mv in ((ref, mv0), (int(comp_b[m][0]), mv1))]
        pred[m] = jmc.compound_average(*sides)
    qc, eo, rec, _, _ = jmd._full_loop(
        srcs, pred, ctts, jcommon.tx_size_for_rect(cw, ch, 1), (cw, ch), qp,
        8, plane_type=1, rdoq_lam_q=jmd.lam_to_q(lam))
    return qc, eo, rec


def test_interp_filter_select_matches_host():
    """One 16x16 group of single-ref and compound blocks (two forward
    references and one backward in the bank) against the host, through
    the rest of the non-fused chain: the filter search, the tx sweep on
    the filtered winner and both chroma planes with the blocks' filters
    and inherited tx types. Textured references; each block's source is
    its winner's prediction under a filter drawn per block, plus noise,
    so every filter wins somewhere."""
    from svt_av1_tpu.entropy.inter_modes import ALTREF_FRAME, GOLDEN_FRAME
    rng = np.random.default_rng(7)
    w, h, size = 128, 64, 16
    refs = {r: [jmc.pad_reference(rng.integers(0, 256, hw).astype(np.uint8))
                for hw in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
            for r in (1, GOLDEN_FRAME, ALTREF_FRAME)}
    order = sorted(refs)
    gx, gy = np.meshgrid(np.arange(0, w, size), np.arange(0, h, size))
    xs, ys = gx.reshape(-1).astype(np.int64), gy.reshape(-1).astype(np.int64)
    b = len(xs)
    mv0, mv1 = (np.array([jmc.clamp_mv_for_padding(m, x, y, size, size, w,
                                                   h)
                          for m, x, y in zip(rng.integers(-40, 40, (b, 2)),
                                             xs, ys)], np.int64)
                for _ in range(2))
    comp = rng.random(b) < 0.4
    fref = rng.choice([1, GOLDEN_FRAME], b)
    chosen_ref = np.where(comp, fref, rng.choice(order, b)).astype(np.int32)
    comp_b = np.where(comp, ALTREF_FRAME, 0).astype(np.int32)
    mv1 = np.where(comp[:, None], mv1, 0)
    host = SimpleNamespace(
        cfg=JaxConfig(width=w, height=h, enable_interp_filter_search=True),
        refs=refs, mvs1=mv1.copy(), interp_f=np.zeros(b, np.int32))
    drawn = rng.integers(0, 3, b)
    srcs = np.clip(jinter.InterFrameEncoder._winner_preds(
        host, xs, ys, size, mv0, chosen_ref, comp, chosen_ref, comp_b, mv1,
        ftype=drawn) + rng.integers(-2, 3, (b, size, size)), 0, 255)
    qidx = 100
    qp = jquant.make_quant_params(qidx)
    lam = jrd.rd_lambda(qidx, 8)
    tx_size = jcommon.tx_size_for_rect(size, size, 0)
    # the REGULAR winner (what the luma stages leave) as the start state
    pred0 = jinter.InterFrameEncoder._winner_preds(
        host, xs, ys, size, mv0, chosen_ref, comp, chosen_ref, comp_b, mv1)
    qc, eo, rec, dist, rate = jmd._full_loop(
        srcs, pred0, np.zeros(b, np.int32), tx_size, (size, size), qp, 8,
        rdoq_lam_q=jmd.lam_to_q(lam))
    chosen = [jmd.rdcost(dist, jmd.lam_to_q(lam), rate), mv0, qc, eo, rec]
    pos = {r: i for i, r in enumerate(order)}
    bank = _t(np.stack([refs[r][0] for r in order]))
    g = {"bank": bank, "srcs": _t(srcs), "mv": _t(mv0), "mv1": _t(mv1),
         "comp": _t(comp), "pos": _t(np.array([pos[r] for r in chosen_ref])),
         "fref": _t(np.array([pos[r] for r in chosen_ref])),
         "bref": _t(np.full(b, pos[ALTREF_FRAME])),
         "cost": _t(chosen[0]), "qc": _t(qc), "eo": _t(eo.astype(np.int64)),
         "rec": _t(rec), "pred": _t(pred0)}
    qv = _t(np.full(b, qidx, np.int32))
    lamqv = _t(np.full(b, jmd.lam_to_q(lam), np.int64))
    tdi.interp_filter_select_j(g, _t(xs), _t(ys), (size, size), qv, lamqv,
                               8, rdoq=True)
    jinter.InterFrameEncoder._interp_filter_select(
        host, np.arange(b), xs, ys, srcs, (size, size), tx_size, chosen,
        chosen_ref, comp, chosen_ref, comp_b, qp, lam)
    _eq(g["ftype"], host.interp_f)
    for k, name in ((0, "cost"), (2, "qc"), (3, "eo"), (4, "rec")):
        _eq(g[name], chosen[k])
    # the group exercises every filter, on single-ref and compound blocks
    assert set(host.interp_f.tolist()) == {0, 1, 2}
    assert (host.interp_f[comp] != 0).any()
    assert (host.interp_f[~comp] != 0).any()

    preds = jinter.InterFrameEncoder._winner_preds(
        host, xs, ys, size, mv0, chosen_ref, comp, chosen_ref, comp_b, mv1,
        ftype=host.interp_f)
    _eq(g["pred"], preds)
    tts = jmd.inter_tx_search(srcs, preds, *chosen[:1], *chosen[2:],
                              tx_size, (size, size), qp, 8, lam, rdoq=True)
    tdi.inter_tx_search_j(g, (size, size), qv, 8, lamqv, rdoq=True)
    _eq(g["tts"], tts)
    for k, name in ((0, "cost"), (2, "qc"), (3, "eo"), (4, "rec")):
        _eq(g[name], chosen[k])
    ctts = np.array([jcommon.chroma_tx_type_inter(
        int(t), jcommon.tx_size_for_rect(size // 2, size // 2, 1), False)
        for t in np.where(chosen[3] > 0, tts, 0)], np.int32)
    src_c = [rng.integers(0, 256, (h // 2, w // 2)) for _ in range(2)]
    banks = [_t(np.stack([refs[r][p] for r in order])) for p in (1, 2)]
    got = tdi.chroma_j(g, *banks, *(_t(p) for p in src_c), _t(xs), _t(ys),
                       (size, size), qv, lamqv, 8, rdoq=True)
    for p in (1, 2):
        want = _host_chroma(refs, src_c[p - 1], p, xs, ys, size, mv0, mv1,
                            chosen_ref, comp, comp_b, host.interp_f, ctts,
                            qp, lam)
        for gv, wv in zip(got, want):
            _eq(gv[(p - 1) * b:p * b], wv)


def _jax_cfg(w, h, preset, levels, qp=40, bit_depth=8, **extra):
    args = SimpleNamespace(width=w, height=h, qp=qp, bit_depth=bit_depth,
                           intra_period=-1, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=levels, tbr=0,
                           lad=0, backend="host")
    return dataclasses.replace(jax_preset_config(args), **extra)


IFS = dict(enable_interp_filter_search=True)
TXS = dict(enable_tx_type_search=True)

# name: (frames, JAX config)
STREAMS = {
    "ifs_low_delay_p": (make_clip(w=128, h=96, frames=4, seed=3),
                        _jax_cfg(128, 96, 5, 0, **IFS)),
    "txs_ra_hier2": (make_clip(w=128, h=64, frames=5, seed=3),
                     _jax_cfg(128, 64, 5, 2, **TXS)),
    "both_ra_hier3_4tiles": (make_clip(w=448, h=128, frames=9, seed=3),
                             _jax_cfg(448, 128, 5, 3, tile_cols_log2=2,
                                      **IFS, **TXS)),
    "preset0_ra_hier2": (make_clip(w=128, h=64, frames=5, seed=3),
                         _jax_cfg(128, 64, 0, 2)),
    "preset1_ra_hier2": (make_clip(w=128, h=64, frames=5, seed=3),
                         _jax_cfg(128, 64, 1, 2)),
    # 8x8 blocks: 4x4 chroma takes the 4-tap banks (SHARP there is the
    # 4-tap REGULAR); every filter wins somewhere
    "both_fixed8_low_delay_p": (make_clip(w=128, h=96, frames=3, seed=3),
                                _jax_cfg(128, 96, 5, 0,
                                         fixed_partition_size=8, **IFS,
                                         **TXS)),
    "both_ra_hier2_10bit": (
        [tuple(p.astype(np.uint16) << 2 for p in f)
         for f in make_clip(w=128, h=64, frames=5, seed=3)],
        _jax_cfg(128, 64, 5, 2, bit_depth=10, **IFS, **TXS)),
    # a half-frame scene change at qp 0 with RDOQ: the flip pass fires
    "qp0_rdoq_flips": (_scene_change_pair(),
                       JaxConfig(width=192, height=128, qp=0,
                                 intra_period=16,
                                 scene_change_detection=False,
                                 intra_modes=(0, 1, 2, 12), **IFS, **TXS)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_search_stream_matches_host_and_decodes(name, monkeypatch):
    frames, jcfg = STREAMS[name]
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    seen = {"groups": 0, "interp_filter_select_j": 0,
            "inter_tx_search_j": 0, "ftype": set(), "tts": set(), "flips": 0}

    def blocks(self, batches, _fn=tinter.InterFrameEncoder._encode_blocks):
        _fn(self, batches)
        seen["groups"] += len(batches)
        seen["ftype"] |= set(self.interp_f.tolist())
        seen["tts"] |= set(self.y_tx_type.tolist())

    def counted(name):
        fn = getattr(tdi, name)

        def call(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return call

    def flip(self, leaves, _fn=tinter.InterFrameEncoder._intra_flip_pass):
        _fn(self, leaves)
        seen["flips"] += int((~self.block_is_inter).sum())

    monkeypatch.setattr(tinter.InterFrameEncoder, "_encode_blocks", blocks)
    monkeypatch.setattr(tdi, "interp_filter_select_j",
                        counted("interp_filter_select_j"))
    monkeypatch.setattr(tdi, "inter_tx_search_j",
                        counted("inter_tx_search_j"))
    monkeypatch.setattr(tinter.InterFrameEncoder, "_intra_flip_pass", flip)
    got, recons = encode_with_recons(frames, cfg)
    assert got == jax_encode_ivf(frames, jcfg)
    assert_decodes_to(got, recons)
    # each enabled search ran on every shape group and changed decisions
    assert seen["groups"] > 0
    assert seen["interp_filter_select_j"] \
        == seen["groups"] * cfg.enable_interp_filter_search
    assert seen["inter_tx_search_j"] \
        == seen["groups"] * cfg.enable_tx_type_search
    if cfg.enable_interp_filter_search:
        assert seen["ftype"] - {0}
    if cfg.enable_tx_type_search and cfg.qp > 0:
        assert seen["tts"] - {0}
    if cfg.qp == 0:
        assert cfg.enable_rdoq and seen["flips"] > 0
