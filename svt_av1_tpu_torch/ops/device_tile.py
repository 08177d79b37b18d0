"""Whole-tile wave programs on the torch device: the port of the JAX
package's ``svt_av1_tpu/ops/device_tile.py``.

**Fused keyframe tile programs.** A key frame's leaves are decided in
coding-order dependency waves; one program runs every wave with the int32
recon planes carried on the device, so no step waits for the host: the
lane metadata (positions, availability, tile bounds, quantizer) is built
on the host once per frame and uploaded once, each shape class runs its
lanes of a wave in one step (``_class_stage``: luma, then U, whose CfL
reads this wave's luma recon, then V forced to U's choice), and the
decisions come back in one download after the last wave. With several
tile columns the tiles' waves merge by index into one frame-batched
program (``run_tiles_fused``): step w runs wave w of every tile, so the
steps are the largest tile's wave count. Availability is tile-local and
edge replication clamps at each lane's tile bounds, so no lane reads
another tile's pixels. The JAX program pads waves to powers of two and
lanes to buckets, with ``mode="drop"`` scatters for the padding; here
the loop over waves is a plain Python loop, and each class step goes
through the encoder's ``step_graphs.ClassGraphs``: eager on the real
lanes on the CPU; on the card replayed as CUDA graphs, its lanes padded
to a power of two by duplicates of the wave's last lane (same position,
flags, qindex and lambda: the same integers and the same pixels written),
whose outputs are cut off, so no drop row or scatter index is added and
no integer changes. Leaves below 8 px have no
fused program (the JAX package's gate): such tiles take the per-wave
loop of ``pipeline/wavefront.py``.

**The intra-flip apply pass** of inter frames.
Blocks that the flip decision turned intra are recoded wave by wave in
coding-order dependency waves, with true final edges: each wave reads the
recon that the earlier waves wrote, so the prediction edges are exactly
those a decoder sees. The JAX program runs the waves as one
``lax.fori_loop`` over bucket-padded lane arrays; here the loop over
waves is a plain Python loop over the real lanes, so no lane is padded,
no scatter needs a drop mode and no index repeats. Each class runs a
wave's lanes in one step: same-wave lanes are mutually edge-independent,
so the JAX package's re-chunking of waves into steps of at most 8 lanes
(which bounds its padded lane width) changes no integer and is not
carried over. Per lane the integer
math is that of ``inter._flip_apply_wave``: the luma full loop with the
chosen mode, then the chroma choice between that mode and CfL.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops import device_md as dmd
from svt_av1_tpu_torch.ops import step_graphs
from svt_av1_tpu_torch.ops.device import const, take2
from svt_av1_tpu_torch.pipeline import common
from svt_av1_tpu_torch.utils.trace import span


def _edges_j(recon, xs, ys, bw: int, bh: int, ha, hl, htr, hbl,
             bd: int, max_w, max_h):
    """Twin of intra_ops.prepare_edges_av1 for lanes at dynamic positions
    (offset-1 edge layout, index 0 = the corner). max_w/max_h: per-lane
    [B] pixel bounds (the tile's right/bottom edges: replication clamps
    there, spec 7.11.2). Returns (above1, left1) int32."""
    base = 1 << (bd - 1)
    hp, wp = recon.shape
    device = recon.device
    w_ = torch.clamp(max_w, max=wp)
    h_ = torch.clamp(max_h, max=hp)
    # above row
    lim = torch.minimum(w_ - 1, xs + torch.where(htr, 2 * bw, bw) - 1)
    cols = torch.minimum(xs[:, None] + torch.arange(bw + bh, device=device),
                         lim[:, None])
    rowy = (ys - 1).clamp(0, hp - 1)
    above_row = take2(recon, rowy[:, None], cols)
    colx = (xs - 1).clamp(0, wp - 1)
    left_px = recon[ys.clamp(0, hp - 1), colx]
    above_tail = torch.where(ha[:, None], above_row,
                             torch.where(hl[:, None], left_px[:, None],
                                         base - 1))
    # left column
    lim2 = torch.minimum(h_ - 1, ys + torch.where(hbl, 2 * bh, bh) - 1)
    rows = torch.minimum(ys[:, None] + torch.arange(bh + bw, device=device),
                         lim2[:, None])
    left_col = take2(recon, rows, colx[:, None])
    above_px = recon[rowy, xs.clamp(0, wp - 1)]
    left_tail = torch.where(hl[:, None], left_col,
                            torch.where(ha[:, None], above_px[:, None],
                                        base + 1))
    corner = torch.where(ha & hl, recon[rowy, colx],
                         torch.where(ha, above_px,
                                     torch.where(hl, left_px, base)))
    above1 = torch.cat([corner[:, None], above_tail], dim=1)
    left1 = torch.cat([corner[:, None], left_tail], dim=1)
    return above1.to(torch.int32), left1.to(torch.int32)


def _narrow_out(out: dict) -> dict:
    """Narrow the per-lane outputs as the JAX programs do before their
    download: levels and eobs to int16 (the quantizer clamps levels to
    int16), alphas to int8."""
    out = dict(out)
    for k, v in out.items():
        if k.startswith(("qc_", "eob_")):
            out[k] = v.to(torch.int16)
        elif k.startswith("alpha_"):
            out[k] = v.to(torch.int8)
    return out


def _gather(plane, xs, ys, bw: int, bh: int):
    iy = ys[:, None, None] + torch.arange(bh, device=plane.device)[
        None, :, None]
    ix = xs[:, None, None] + torch.arange(bw, device=plane.device)[
        None, None, :]
    return take2(plane, iy, ix)


def _scatter(plane, xs, ys, blocks, bw: int, bh: int) -> None:
    """Write [B, bh, bw] blocks into ``plane`` in place (the lanes of one
    step are disjoint blocks, and every lane is real)."""
    iy = ys[:, None, None] + torch.arange(bh, device=plane.device)[
        None, :, None]
    ix = xs[:, None, None] + torch.arange(bw, device=plane.device)[
        None, None, :]
    plane[iy, ix] = blocks.to(plane.dtype)


# --- fused keyframe tile programs ---------------------------------------------
# per-lane operands of a class step, the rows of its packed int64 lanes
# [len(LANE_KEYS), B], uploaded once per frame
LANE_KEYS = ("xs", "ys", "ha", "hl", "htr", "hbl", "mwv", "mhv", "qv",
             "lamqv")
_FLAGS = ("ha", "hl", "htr", "hbl")
# per-lane decisions, stacked into one int64 row each for the download
SMALL_KEYS = ("y_mode", "y_delta", "uv_mode", "uv_delta", "alpha_u",
              "alpha_v", "y_tx_type", "eob_y", "eob_u", "eob_v")


def _lane_rows(lanes) -> tuple:
    """The packed lanes' rows in LANE_KEYS order: the flags as bool, the
    qindex as int32, the others int64."""
    return tuple(lanes[i] != 0 if k in _FLAGS else
                 lanes[i].to(torch.int32) if k == "qv" else
                 lanes[i].contiguous() for i, k in enumerate(LANE_KEYS))


def _class_order(shapes) -> list:
    """Class order inside a wave: descending area, then descending width
    (the JAX programs' order; same-wave lanes are independent, so it
    changes no integer, but it is kept)."""
    return sorted(shapes, key=lambda s: (-s[0] * s[1], -s[0]))


def _class_stage(shape: tuple, cands: tuple, bd: int, nfl: int,
                 tx_search: bool, rdoq: bool = False):
    """The step of one (bw, bh) shape class: the Y, U, V decide chain of
    its lanes of one wave (packed [len(LANE_KEYS), B]), writing their
    recon into the int32 planes in place. Returns (small [10, B] int64 in
    SMALL_KEYS order, qc_y, qc_u, qc_v)."""
    bw, bh = shape
    cw_, ch_ = bw >> 1, bh >> 1
    cfl_ok = bw <= 32 and bh <= 32    # cfl_allowed (host wavefront rule)
    ysz = bw if bw == bh else (bw, bh)
    csz = cw_ if cw_ == ch_ else (cw_, ch_)
    decide_y = dmd.make_decide_core(0, cands, ysz, bd, nfl, False, False,
                                    False, tx_search, rdoq)
    decide_u = dmd.make_decide_core(1, cands, csz, bd, nfl, False, False,
                                    cfl_ok, False, rdoq)
    decide_v = dmd.make_decide_core(2, cands, csz, bd, nfl, False, True,
                                    cfl_ok, False, rdoq)

    def step(recon, src, lanes):
        xs, ys, ha, hl, htr, hbl, mwv, mhv, qv, lamqv = _lane_rows(lanes)
        a1, l1 = _edges_j(recon[0], xs, ys, bw, bh, ha, hl, htr, hbl, bd,
                          mwv, mhv)
        srcs = _gather(src[0], xs, ys, bw, bh)
        ym, yd, qcy, eoy, recy, _, _, ytt = decide_y(
            srcs, a1, l1, ha, hl, None, qv, lamqv)
        _scatter(recon[0], xs, ys, recy, bw, bh)
        cxs, cys = xs >> 1, ys >> 1
        # CfL reads this wave's luma recon: gathered after its scatter
        cfl = _gather(recon[0], xs, ys, bw, bh) if cfl_ok else None
        a1u, l1u = _edges_j(recon[1], cxs, cys, cw_, ch_, ha, hl, htr, hbl,
                            bd, mwv >> 1, mhv >> 1)
        um, ud, qcu, eou, recu, _, au, _ = decide_u(
            _gather(src[1], cxs, cys, cw_, ch_), a1u, l1u, ha, hl, cfl, qv,
            lamqv)
        _scatter(recon[1], cxs, cys, recu, cw_, ch_)
        a1v, l1v = _edges_j(recon[2], cxs, cys, cw_, ch_, ha, hl, htr, hbl,
                            bd, mwv >> 1, mhv >> 1)
        _, _, qcv, eov, recv, _, av, _ = decide_v(
            _gather(src[2], cxs, cys, cw_, ch_), a1v, l1v, ha, hl, um, ud,
            cfl, qv, lamqv)
        _scatter(recon[2], cxs, cys, recv, cw_, ch_)
        small = torch.stack([t.to(torch.int64) for t in
                             (ym, yd, um, ud, au, av, ytt, eoy, eou, eov)])
        return small, qcy, qcu, qcv

    return step


def make_mixed_tile_body(class_spec: tuple, n_waves: int, cands: tuple,
                         bd: int, nfl: int, tx_search: bool,
                         rdoq: bool = False):
    """The wave loop over the classes ``class_spec`` ((bw, bh), ... in
    their order inside a wave). The returned program takes the source
    planes, the recon plane shapes, per class its packed lanes (in wave
    order, each wave's padded as ``_lanes_of`` pads them), per class and
    wave the (start, end) of its real lanes and the offset of its packed
    ones, and the runner of the class steps (``step_graphs.ClassGraphs``);
    it returns the int32 recon planes, per class
    (small, qc_y, qc_u, qc_v) of its lanes in lane order (the levels
    narrowed to int16), and the number of class steps it ran. No
    operation inside the loop waits for the device."""
    keys = [(sh, cands, bd, nfl, tx_search, rdoq) for sh in class_spec]
    stages = [_class_stage(*k) for k in keys]

    def program(src, shapes, lanes, ranges, runner):
        recon = runner.recon(shapes, src[0].device)
        res = [None] * len(stages)
        steps = 0
        for w in range(n_waves):
            for ci, stage in enumerate(stages):
                s, e, off = ranges[ci][w]
                if e == s:
                    continue
                out = runner.step(stage, keys[ci], recon, src, lanes[ci],
                                  off, e - s)
                if res[ci] is None:     # lanes of the class, in all waves
                    n = ranges[ci][-1][1]
                    res[ci] = [out[0].new_empty((out[0].shape[0], n))] + [
                        q.new_empty((n,) + q.shape[1:], dtype=torch.int16)
                        for q in out[1:]]
                res[ci][0][:, s:e] = out[0][:, :e - s]
                for acc, q in zip(res[ci][1:], out[1:]):
                    acc[s:e] = q[:e - s]
                steps += 1
        return recon, [tuple(r) for r in res], steps

    return program


def tile_lane_meta(enc, cands):
    """Lane metadata of one tile for the fused programs, or None when the
    tile has leaves below 8 px (the JAX package's gate; the per-wave loop
    takes such tiles). Call with ``enc`` entered into the tile; captures
    the tile's decision arrays for the injection. The JAX package also
    declines a tile whose class holds more lanes in one wave than it has
    block bands; that bound sizes its padded lane arrays, which the port
    does not have, so it is not carried over."""
    from svt_av1_tpu_torch.pipeline import avail
    leaves = enc._leaves()
    if not leaves or any(wh[0] < 8 or wh[1] < 8 for _, _, wh in leaves):
        return None
    waves = enc._dependency_waves(leaves, enc.mi_cols, enc.mi_rows)
    larr = np.array([(r, c, wh[0], wh[1]) for r, c, wh in leaves],
                    dtype=np.int64)
    classes = {}
    for sh in {tuple(wh) for _, _, wh in leaves}:
        li = np.nonzero((larr[:, 2] == sh[0]) & (larr[:, 3] == sh[1]))[0]
        rs, cs = larr[li, 0], larr[li, 1]
        w4, h4 = sh[0] >> 2, sh[1] >> 2
        vab = avail.leaf_vert_ab_flags(enc.leaf_sizes, rs, cs, w4, h4,
                                       enc.mi_rows, enc.mi_cols)
        classes[sh] = dict(
            wave=waves[li], r=rs, c=cs, li=li,
            htr=avail.has_top_right_wh_vec(rs, cs, w4, h4, enc.mi_cols,
                                           vert_ab=vab),
            hbl=avail.has_bottom_left_wh_vec(rs, cs, w4, h4, enc.mi_rows,
                                             vert_ab=vab))
    arrays = {k: getattr(enc, k) for k in
              ("y_mode", "y_delta", "uv_mode", "uv_delta", "alpha_u",
               "alpha_v", "y_tx_type", "eobs", "qcoeff")}
    return dict(rect=enc._cur_rect, n_waves=int(waves.max()) + 1,
                classes=classes, arrays=arrays)


def _lanes_of(metas, shapes_u, qindex: int, lamq: int, device):
    """Per class: the lanes of every tile packed tile after tile (the
    JAX package's contiguous ``idxw`` packing, entry base ``j0`` per
    tile), then ordered by wave (stable) for the loop. Frame-global
    positions, tile-local availability, each lane's tile right/bottom
    bound. Each wave's lanes are followed by their pad to
    ``step_graphs.lane_bucket`` (copies of its last lane). One upload for
    all classes. Returns (lanes, ranges, places, positions): lanes per
    class [len(LANE_KEYS), padded lanes] int64, ranges per class and wave
    (start, end, offset): the real lanes' loop-order range and their
    packed offset; places [(meta, tile leaf ids, j0)], positions[j] the
    loop-order lane of packed entry j."""
    n_waves = max(m["n_waves"] for m in metas)
    rows, ranges, places, positions = [], [], [], []
    for sh in shapes_u:
        cols, place, j = [], [], 0
        for m in metas:
            ent = m["classes"].get(sh)
            if ent is None:
                continue
            mi_r0, mi_c0, mi_rs, mi_cs = m["rect"][:4]
            y0, x0 = mi_r0 * 4, mi_c0 * 4
            n = len(ent["li"])
            cols.append(np.stack([
                ent["wave"], x0 + ent["c"] * 4, y0 + ent["r"] * 4,
                ent["r"] > 0, ent["c"] > 0, ent["htr"], ent["hbl"],
                np.full(n, x0 + mi_cs * 4), np.full(n, y0 + mi_rs * 4),
                np.full(n, qindex), np.full(n, lamq)]).astype(np.int64))
            place.append((m, ent["li"], j))
            j += n
        host = np.concatenate(cols, axis=1)
        order = np.argsort(host[0], kind="stable")
        pos = np.empty(j, np.int64)
        pos[order] = np.arange(j)
        bounds = np.searchsorted(host[0, order], np.arange(n_waves + 1))
        idx, rng = [], []
        for w in range(n_waves):
            s, e = int(bounds[w]), int(bounds[w + 1])
            rng.append((s, e, len(idx)))
            if e > s:
                idx += list(range(s, e)) \
                    + [e - 1] * (step_graphs.lane_bucket(e - s) - (e - s))
        rows.append(host[1:, order[idx]])
        ranges.append(rng)
        places.append(place)
        positions.append(pos)
    packed = const(np.concatenate(rows, axis=1), device)
    lanes, off = [], 0
    for r in rows:
        lanes.append(packed[:, off:off + r.shape[1]])
        off += r.shape[1]
    return lanes, ranges, places, positions


def _run_program(enc, metas, src_planes, shapes, cands):
    """Upload, run the wave loop over every meta's lanes, download the
    decisions and inject them (coefficients as PendingQC markers).
    ``src_planes``: the host planes the metas' rects index. Returns the
    int32 recon planes on the device."""
    from svt_av1_tpu_torch.pipeline import md as md_mod
    cfg = enc.cfg
    device = torch.device(cfg.device)
    pdt = dev.pix_dtype(cfg.bit_depth)
    n_waves = max(m["n_waves"] for m in metas)
    shapes_u = _class_order({sh for m in metas for sh in m["classes"]})
    runner = enc.class_graphs
    with span("tile_lanes"):
        lanes, ranges, places, positions = _lanes_of(
            metas, shapes_u, int(enc.qp.qindex), md_mod.lam_to_q(enc.lam),
            device)
        src = runner.source(src_planes, pdt, device)
    prog = make_mixed_tile_body(
        tuple(shapes_u), n_waves, tuple(map(tuple, cands)), cfg.bit_depth,
        cfg.nfl, bool(cfg.enable_tx_type_search and cfg.base_q_idx > 0),
        bool(cfg.enable_rdoq))
    n_lanes = int(sum(len(p) for p in positions))
    before = runner.counts()
    with span("tile_program", lanes=n_lanes) as rec:
        recon, outs, steps = prog(src, shapes, lanes, ranges, runner)
    graphs = {k: v - before[k] for k, v in runner.counts().items()}
    if rec is not None:
        rec["class_steps"] = steps
        rec.update(graphs)
    enc.fused_stats = dict(tiles=len(metas), wave_steps=n_waves,
                           class_steps=steps, classes=len(shapes_u),
                           lanes=n_lanes, **graphs)
    with span("tile_inject"):
        inject_results(places, positions, outs)
    return recon


def inject_results(places, positions, outs) -> None:
    """Write the program's outputs back into each tile's decision arrays:
    the small decisions through one download, the coefficients as
    ``(PendingQC, lane)`` markers (one pinned async copy per class and
    plane, started before that download so the two overlap; the entropy
    worker resolves them)."""
    from svt_av1_tpu_torch.pipeline.common import PendingQC
    pending = [[PendingQC(q) for q in out[1:]] for out in outs]
    small = torch.cat([o[0] for o in outs], dim=1).cpu().numpy()
    off = 0
    for place, pos, pends in zip(places, positions, pending):
        for m, ids, j0 in place:
            a = m["arrays"]
            lane = pos[j0:j0 + len(ids)]
            vals = dict(zip(SMALL_KEYS, small[:, off + lane]))
            for k in ("y_mode", "y_delta", "uv_mode", "uv_delta", "alpha_u",
                      "alpha_v", "y_tx_type"):
                a[k][ids] = vals[k]
            for p, k in enumerate(("eob_y", "eob_u", "eob_v")):
                a["eobs"][p, ids] = vals[k]
            for li, ln in zip(ids.tolist(), lane.tolist()):
                for p in range(3):
                    a["qcoeff"][p][li] = (pends[p], ln)
        off += len(pos)


def _run_single(enc, meta, cands) -> None:
    """One tile's program on the tile's own planes (tile-local rect). On
    a one-tile frame the recon stays on the device (``dev.pix_dtype``
    planes replace ``enc.recon``), else it lands in the host views."""
    meta = dict(meta, rect=(0, 0, enc.mi_rows, enc.mi_cols))
    store_recon(enc, _run_program(enc, [meta], enc.src,
                                  [tuple(p.shape) for p in enc.recon], cands))


def store_recon(enc, recon) -> None:
    """A tile program's recon planes into the tile ``enc`` is entered
    into: on a one-tile frame they stay on their device
    (``dev.pix_dtype`` planes replace ``enc.recon``), else they land in
    the host views."""
    pdt = dev.pix_dtype(enc.cfg.bit_depth)
    if getattr(enc, "_tile_count", 1) == 1:
        enc.recon = [p.to(pdt) for p in recon]
        return
    for dst, t in zip(enc.recon, recon):
        dst[...] = t.cpu().numpy().astype(dst.dtype)


def tile_metadata(enc, cands):
    """Lane metadata for the uniform-leaf program, or None when the tile's
    leaves are not all one square size of at least 8 px. The JAX
    package's uniform program (``make_tile_body``) computes the same
    integers as its class step on such a tile (one class, the same decide
    cores, CfL at S <= 32, the same clamps), so the port runs both entry
    points through the one class-step program."""
    sizes = set(enc.leaf_sizes.values())
    if len(sizes) != 1:
        return None
    s = sizes.pop()
    if not isinstance(s, (int, np.integer)) or s < 8:
        return None
    return tile_lane_meta(enc, cands)


def tile_body_operands(enc, cands):
    """(program key, operands) of ``make_tile_body`` for the tile ``enc``
    is entered into (the JAX package's ``tile_metadata``), or None when
    its leaves are not all one square size of at least 8 px or it has a
    per-SB qindex map. The operands are numpy: the source planes, per
    wave the lanes' positions, valid flags, above-right / bottom-left
    availability and leaf indices padded to the widest wave, and the
    qindex and lambda scalars."""
    from svt_av1_tpu_torch.pipeline import avail
    from svt_av1_tpu_torch.pipeline import md as md_mod
    cfg = enc.cfg
    sizes = set(enc.leaf_sizes.values())
    if len(sizes) != 1 or enc.qmap_t is not None:
        return None
    s = sizes.pop()
    if not isinstance(s, (int, np.integer)) or s < 8:
        return None
    leaves = enc._leaves()
    waves = enc._dependency_waves(leaves, enc.mi_cols, enc.mi_rows)
    n = len(leaves)
    n_waves = int(waves.max()) + 1 if n else 0
    wmax = int(np.bincount(waves).max())
    xsw, ysw, idxw = (np.zeros((n_waves, wmax), np.int64) for _ in range(3))
    validw, htrw, hblw = (np.zeros((n_waves, wmax), bool) for _ in range(3))
    fill = np.zeros(n_waves, dtype=np.int64)
    for i, (r, c, wh) in enumerate(leaves):
        w = int(waves[i])
        j = fill[w]
        fill[w] = j + 1
        xsw[w, j], ysw[w, j], validw[w, j] = c * 4, r * 4, True
        vab = avail.leaf_vert_ab(enc.leaf_sizes, r, c, wh[0] >> 2,
                                 wh[1] >> 2, enc.mi_rows, enc.mi_cols)
        htrw[w, j] = avail.has_top_right_wh(r, c, wh[0] >> 2, wh[1] >> 2,
                                            enc.mi_cols, vert_ab=vab)
        hblw[w, j] = avail.has_bottom_left_wh(r, c, wh[0] >> 2, wh[1] >> 2,
                                              enc.mi_rows, vert_ab=vab)
        idxw[w, j] = enc.leaf_index[(r, c)]
    key = (int(s), tuple(map(tuple, cands)), cfg.bit_depth, cfg.nfl,
           bool(cfg.enable_tx_type_search and cfg.base_q_idx > 0),
           n_waves, wmax, n,
           (tuple(enc.recon[0].shape), tuple(enc.recon[1].shape)),
           (tuple(enc.max_wh[0]), tuple(enc.max_wh[1])),
           bool(cfg.enable_rdoq))
    npix = np.uint8 if cfg.bit_depth <= 8 else np.int16
    args = tuple(np.ascontiguousarray(p, dtype=npix) for p in enc.src[:3]) \
        + (xsw, ysw, validw, htrw, hblw, idxw,
           np.full((), int(enc.qp.qindex), np.int32),
           np.full((), md_mod.lam_to_q(enc.lam), np.int64))
    return key, args


# the uniform program's outputs, in the JAX program's order: the per-leaf
# decisions (SMALL_KEYS with ``y_tt`` for ``y_tx_type``), then the levels
TILE_BODY_KEYS = ("y_mode", "y_delta", "uv_mode", "uv_delta", "alpha_u",
                  "alpha_v", "y_tt", "eob_y", "eob_u", "eob_v", "qc_y",
                  "qc_u", "qc_v")


@functools.lru_cache(maxsize=64)
def make_tile_body(size: int, cands: tuple, bd: int, nfl: int,
                   tx_search: bool, n_waves: int, wmax: int, n_leaves: int,
                   shapes: tuple, max_wh: tuple, rdoq: bool = False):
    """The uniform-leaf tile program with the JAX package's signature
    (``make_tile_body``; ``tile_body_operands`` gives the key and the
    operands): one S x S shape class through the class step of the fused
    programs (``_class_stage``, the same decide cores, CfL at S <= 32,
    the same clamps), wave after wave. ``shapes``: ((Hy, Wy), (Hc, Wc))
    padded plane dims; ``max_wh``: ((wy, hy), (wc, hc)) mi-area bounds.

    The returned program takes the operands as tensors on one device
    (src_y, src_u, src_v, xsw, ysw, validw, htrw, hblw, idxw [n_waves,
    wmax], qv, lamqv) and the runner of its class steps
    (``step_graphs.ClassGraphs``: one a caller keeps per device serves
    every tile it runs there) and returns (recon y, u, v in ``dev.pix_dtype``,
    {TILE_BODY_KEYS: [n_leaves + 1, ...]}) on that device, each leaf's
    outputs at its leaf index, narrowed as the JAX program narrows them:
    modes, deltas, alphas and the tx type to int8, eobs and levels to
    int16. The lanes of a wave are its valid prefix (one read of the
    counts before the loop); the loop runs them through the runner,
    packed and padded as the frame program's. The JAX
    program writes its padding lanes to the extra row n_leaves (an index
    inside its arrays, so its drop mode drops nothing): a padding lane
    decides the block at (0, 0) with no neighbours, which is the first
    leaf's decision, so that row holds the first leaf's outputs whenever
    a wave is not full, and zeros otherwise."""
    S = size
    key = ((S, S), cands, bd, nfl, tx_search, rdoq)
    step = _class_stage(*key)
    (hy, wy), (hc, wc) = shapes
    mwy, mhy = max_wh[0]
    pdt = dev.pix_dtype(bd)
    tx_y = common.tx_size_for_rect(S, S, 0)
    tx_uv = common.tx_size_for_rect(S >> 1, S >> 1, 1)

    def program(src_y, src_u, src_v, xsw, ysw, validw, htrw, hblw, idxw,
                qv, lamqv, *, runner):
        device = src_y.device
        src = runner.source((src_y, src_u, src_v), src_y.dtype, device)
        recon = runner.recon(((hy, wy), (hc, wc), (hc, wc)), device)
        n1 = n_leaves + 1
        small = torch.zeros((len(SMALL_KEYS), n1), dtype=torch.int64,
                            device=device)
        qcs = [torch.zeros((n1,) + tuple(reversed(common.coded_dims(t))),
                           dtype=torch.int32, device=device)
               for t in (tx_y, tx_uv, tx_uv)]
        counts = validw.sum(dim=1).tolist()
        full = torch.ones_like(xsw)
        grid = torch.stack([r.to(torch.int64) for r in (
            xsw, ysw, ysw > 0, xsw > 0, htrw, hblw, full * mwy, full * mhy,
            full * qv.to(torch.int64), full * lamqv.to(torch.int64))])
        idx, waves = [], []
        for w, k in enumerate(counts):
            if k:
                waves.append((w, k, len(idx)))
                idx += [w * wmax + min(j, k - 1)
                        for j in range(step_graphs.lane_bucket(k))]
        lanes = grid.reshape(len(LANE_KEYS), -1)[
            :, const(np.array(idx, np.int64), device)]
        for w, k, off in waves:
            out = runner.step(step, key, recon, src, lanes, off, k)
            ix = idxw[w, :k]
            small[:, ix] = out[0][:, :k]
            for q, o in zip(qcs, out[1:]):
                q[ix] = o[:k].to(torch.int32)
        if n_leaves and min(counts) < wmax:
            first = idxw[0, 0]
            small[:, n_leaves] = small[:, first]
            for q in qcs:
                q[n_leaves] = q[first]
        res = dict(zip(TILE_BODY_KEYS[:10], small))
        for k, v in res.items():
            res[k] = v.to(torch.int16 if k.startswith("eob_") else torch.int8)
        res.update(zip(TILE_BODY_KEYS[10:], (q.to(torch.int16) for q in qcs)))
        return tuple(p.to(pdt) for p in recon) + (res,)

    return program


def analyze_tile_fused(enc, cands) -> bool:
    """The fused program for a tile of uniform square leaves: fills the
    tile's decisions and recon; False when the tile is not uniform."""
    meta = tile_metadata(enc, cands)
    if meta is None:
        return False
    _run_single(enc, meta, cands)
    return True


def analyze_tile_fused_mixed(enc, cands) -> bool:
    """The fused program for a tile of mixed leaf shapes (squares and
    rects); False for leaves below 8 px. The JAX package's
    ``mixed_tile_metadata`` gate is ``tile_lane_meta``'s."""
    meta = tile_lane_meta(enc, cands)
    if meta is None:
        return False
    _run_single(enc, meta, cands)
    return True


def run_tiles_fused(enc, metas, frame_src, frame_recon, cands):
    """ONE program over every deferred tile's lanes of the frame: step w
    runs wave w of every tile. Injects the decisions into each tile's
    arrays. Returns the frame recon planes: on the device in
    ``dev.pix_dtype`` when every tile deferred, else the host planes with
    the deferred tiles' regions copied in."""
    recon = _run_program(enc, metas, frame_src,
                         [tuple(p.shape) for p in frame_recon], cands)
    if len(metas) == enc._tile_count:
        pdt = dev.pix_dtype(enc.cfg.bit_depth)
        return [p.to(pdt) for p in recon]
    host = [t.cpu().numpy() for t in recon]
    for m in metas:             # copy only the deferred tiles' pixels
        mi_r0, mi_c0, mi_rs, mi_cs = m["rect"][:4]
        for p, ss in ((0, 0), (1, 1), (2, 1)):
            ys = slice((mi_r0 * 4) >> ss, ((mi_r0 + mi_rs) * 4) >> ss)
            xs = slice((mi_c0 * 4) >> ss, ((mi_c0 + mi_cs) * 4) >> ss)
            frame_recon[p][ys, xs] = host[p][ys, xs]
    return frame_recon


def _flip_stage(shape: tuple, bd: int, rdoq: bool = False):
    """The step of one shape class: recode its lanes of one wave in place
    in the int32 recon planes; returns the lanes' outputs."""
    from svt_av1_tpu_torch.ops.device_md import (_full_loop_j, _rdcost_j,
                                                 cfl_fit_alpha_j,
                                                 cfl_predict_j,
                                                 luma_ac_420_j,
                                                 predict_any_j)
    from svt_av1_tpu_torch.pipeline import md as md_mod
    bw, bh = shape
    cw_, ch_ = bw >> 1, bh >> 1
    cfl_ok = bw <= 32 and bh <= 32
    tx_y = common.tx_size_for_rect(bw, bh, 0)
    tx_uv = common.tx_size_for_rect(cw_, ch_, 1)

    def select(modes, fm, pred_of, b, h, w, device):
        pred = torch.zeros((b, h, w), dtype=torch.int64, device=device)
        for m in modes:
            pred = torch.where((fm == m)[:, None, None], pred_of(m).long(),
                               pred)
        return pred

    def step(recon, src, lanes, modes: tuple):
        """recon/src: [y, u, v]; lanes: the class's lane tensors of this
        step; modes: the forced modes that occur among them."""
        xs, ys, ha, hl = lanes["xs"], lanes["ys"], lanes["ha"], lanes["hl"]
        htr, hbl, mwv, mhv = lanes["htr"], lanes["hbl"], lanes["mwv"], \
            lanes["mhv"]
        fm, qv, lamqv = lanes["fm"], lanes["qv"], lanes["lamqv"]
        b = xs.shape[0]
        device = xs.device
        rlq = lamqv if rdoq else None
        zeros_tt = torch.zeros(b, dtype=torch.int32, device=device)
        # --- luma (forced mode per lane) ---
        a1, l1 = _edges_j(recon[0], xs, ys, bw, bh, ha, hl, htr, hbl, bd,
                          mwv, mhv)
        srcs = _gather(src[0], xs, ys, bw, bh).long()
        pred = select(modes, fm, lambda m: predict_any_j(
            m, 0, a1, l1, bw, bh, ha, hl, bd), b, bh, bw, device)
        qcy, eoy, recy, _, _ = _full_loop_j(
            srcs, pred, zeros_tt, (0,), tx_y, (bw, bh), qv, bd, 0,
            rdoq_lam_qv=rlq)
        _scatter(recon[0], xs, ys, recy, bw, bh)
        # --- chroma: per-lane {luma mode, CfL} joint pick ---
        cxs, cys = xs >> 1, ys >> 1
        ac = None
        if cfl_ok:
            ac = luma_ac_420_j(_gather(recon[0], xs, ys, bw, bh).long())
        tt_lut = np.zeros(16, np.int32)
        for m in modes:
            tt_lut[m] = common.chroma_tx_type(m, tx_uv, False)
        tt_set = tuple(sorted({int(tt_lut[m]) for m in modes}))
        tts = const(tt_lut, device)[fm.long()]
        res = {}
        for plane in (1, 2):
            a1c, l1c = _edges_j(recon[plane], cxs, cys, cw_, ch_, ha, hl,
                                htr, hbl, bd, mwv >> 1, mhv >> 1)
            srcs_c = _gather(src[plane], cxs, cys, cw_, ch_).long()
            predc = select(modes, fm, lambda m: predict_any_j(
                m, 0, a1c, l1c, cw_, ch_, ha, hl, bd), b, ch_, cw_, device)
            # plane type 0 (the luma trim and rate tables) in both chroma
            # loops: the JAX package's host recode (_flip_apply_wave), whose
            # streams are the reference, codes them so; its device twin
            # takes the chroma tables and can pick otherwise
            qcp, eop, recp, dist, rate = _full_loop_j(
                srcs_c, predc, tts, tt_set, tx_uv, (cw_, ch_), qv, bd, 0,
                rdoq_lam_qv=rlq)
            cost_m = _rdcost_j(dist, lamqv, rate)
            cfl = None
            if cfl_ok:
                dc = dev.predict_modes((0,), a1c[:, 1:], l1c[:, 1:],
                                       a1c[:, 0], ha, hl, cw_, ch_, bd)[0]
                alpha = cfl_fit_alpha_j(ac, srcs_c, dc)
                cpred = cfl_predict_j(dc, ac, alpha, bd).long()
                qc2, eo2, rec2, dist2, rate2 = _full_loop_j(
                    srcs_c, cpred, zeros_tt, (0,), tx_uv, (cw_, ch_), qv,
                    bd, 0, rdoq_lam_qv=rlq)
                cfl = (qc2, eo2, rec2, _rdcost_j(
                    dist2, lamqv, rate2 + (4 << md_mod.RATE_Q)), alpha)
            res[plane] = ((qcp, eop, recp, cost_m), cfl)
        if cfl_ok:
            use = (res[1][1][3] + res[2][1][3] < res[1][0][3] + res[2][0][3]) \
                & ~((res[1][1][4] == 0) & (res[2][1][4] == 0))
        else:
            use = torch.zeros(b, dtype=torch.bool, device=device)
        out = {"qc_y": qcy, "eob_y": eoy, "use_cfl": use}
        for plane, p in ((1, "u"), (2, "v")):
            (qcp, eop, recp, _), cfl = res[plane]
            if cfl_ok:
                qc2, eo2, rec2, _, alpha = cfl
                qsel = torch.where(use[:, None, None], qc2, qcp)
                esel = torch.where(use, eo2, eop)
                rsel = torch.where(use[:, None, None], rec2, recp)
                asel = torch.where(use, alpha, 0)
            else:
                qsel, esel, rsel = qcp, eop, recp
                asel = torch.zeros(b, dtype=torch.int64, device=device)
            _scatter(recon[plane], cxs, cys, rsel, cw_, ch_)
            out[f"qc_{p}"], out[f"eob_{p}"], out[f"alpha_{p}"] = \
                qsel, esel, asel
        return out

    return step


def make_flip_body(class_spec: tuple, n_waves: int, bd: int,
                   rdoq: bool = False):
    """class_spec: ((bw, bh), ...) in the order the classes run inside a
    wave. The returned program takes the current inter recon planes (the
    pass repairs poorly-predicted blocks in place), the source planes and
    per class its lanes (tensors in wave order), the [start, end) lane
    range of every wave and the modes that occur in each; it returns the
    recon planes (pixel dtype) and per class the narrowed outputs of its
    lanes in lane order."""
    stages = [_flip_stage(sh, bd, rdoq=rdoq) for sh in class_spec]

    def program(ry, ru, rv, src, lanes, ranges, modes):
        recon = [p.to(torch.int32) for p in (ry, ru, rv)]
        outs = [[] for _ in stages]
        for w in range(n_waves):
            for ci, step in enumerate(stages):
                s, e = ranges[ci][w]
                if e > s:
                    outs[ci].append(step(
                        recon, src, {k: v[s:e] for k, v in lanes[ci].items()},
                        modes[ci][w]))
        narrow = [_narrow_out({k: torch.cat([o[k] for o in per])
                               for k in per[0]}) for per in outs]
        return [p.to(ry.dtype) for p in recon], narrow

    return program


def flip_apply_fused(enc, waves) -> None:
    """The whole intra-flip apply pass (inter.InterFrameEncoder's waves of
    accepted flips) on the recon's device. ``waves``: output of
    enc._flip_waves — lists of (r, c, size, li, mode) in coding order.
    At qindex 0 with RDOQ, where the JAX package recodes on the host
    (``_flip_apply_wave``), the same integers come from here: the trim
    leaves qindex-0 lanes untouched, as the host gates it off."""
    from svt_av1_tpu_torch.pipeline import avail, md
    from svt_av1_tpu_torch.pipeline.common import PendingQC
    cfg = enc.cfg
    if not waves:
        return
    qcache = {}

    def lane_q(r, c):
        qidx = None if enc.qmap is None \
            else int(enc.qmap[r // 16, c // 16])
        ent = qcache.get(qidx)
        if ent is None:
            qp, lam = enc._qp_for(qidx)
            ent = (int(qp.qindex), md.lam_to_q(lam))
            qcache[qidx] = ent
        return ent

    classes = {}
    for w, wave in enumerate(waves):
        for (r, c, size, li, m) in wave:
            qi, lamq = lane_q(r, c)
            classes.setdefault(common.leaf_wh(size), []) \
                .append((w, r, c, li, m, qi, lamq))
    order = sorted(classes)
    device = enc.recon[0].device
    lanes, ranges, modes = [], [], []
    for sh in order:
        ent = classes[sh]
        w4, h4 = sh[0] >> 2, sh[1] >> 2
        wv = np.array([e[0] for e in ent])
        rs = np.array([e[1] for e in ent])
        cs = np.array([e[2] for e in ent])
        fm = np.array([e[4] for e in ent])
        # availability + edge replication clip at tile bounds (spec
        # 7.10.2 / 7.11.2)
        lr_, lc_, trs, tcs = enc._tile_local_coords(rs, cs)
        vab = avail.leaf_vert_ab_flags(enc.leaf_sizes, rs, cs, w4, h4,
                                       enc.mi_rows, enc.mi_cols)
        host = dict(
            xs=cs * 4, ys=rs * 4,
            ha=lr_ > 0, hl=lc_ > 0,
            htr=avail.has_top_right_wh_vec(lr_, lc_, w4, h4, tcs,
                                           vert_ab=vab),
            hbl=avail.has_bottom_left_wh_vec(lr_, lc_, w4, h4, trs,
                                             vert_ab=vab),
            mwv=(cs - lc_ + tcs) * 4, mhv=(rs - lr_ + trs) * 4, fm=fm,
            qv=np.array([e[5] for e in ent], np.int32),
            lamqv=np.array([e[6] for e in ent], np.int64))
        lanes.append({k: const(np.asarray(
            v, bool if k in ("ha", "hl", "htr", "hbl")
            else (np.int32 if k == "qv" else np.int64)), device)
            for k, v in host.items()})
        bounds = np.searchsorted(wv, np.arange(len(waves) + 1))
        ranges.append([(int(bounds[w]), int(bounds[w + 1]))
                       for w in range(len(waves))])
        modes.append([tuple(sorted(set(fm[bounds[w]:bounds[w + 1]]
                                       .tolist())))
                      for w in range(len(waves))])
    prog = make_flip_body(tuple(order), len(waves), cfg.bit_depth,
                          bool(cfg.enable_rdoq))
    recon, outs = prog(enc.recon[0], enc.recon[1], enc.recon[2],
                       enc.src, lanes, ranges, modes)
    enc.recon = recon
    # the coefficient tensors are resolved on the entropy thread
    # (PendingQC starts their copies now); the small outputs come back here
    for ci, sh in enumerate(order):
        o = outs[ci]
        pends = [PendingQC(o[f"qc_{p}"]) for p in ("y", "u", "v")]
        small = {k: v.cpu().numpy() for k, v in o.items()
                 if not k.startswith("qc_")}
        for j, (w, r, c, li, m, qi, lamq) in enumerate(classes[sh]):
            enc.block_is_inter[li] = False
            enc.intra_mode[li] = m
            for p in range(3):
                enc.qcoeff[p][li] = (pends[p], j)
            enc.eobs[0, li] = small["eob_y"][j]
            enc.eobs[1, li] = small["eob_u"][j]
            enc.eobs[2, li] = small["eob_v"][j]
            enc.intra_uv_cfl[li] = small["use_cfl"][j]
            enc.intra_alpha_u[li] = small["alpha_u"][j]
            enc.intra_alpha_v[li] = small["alpha_v"][j]
