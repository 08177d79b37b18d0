"""Partition RD search: batched per-depth analysis + block-tree DP.

Port of the JAX package's ``pipeline/rd.py`` intra partition search (the
reference's recursive ``mode_decision_sb``, EbProductCodingLoop.c:2690,
re-expressed as batched passes): every block of each depth (64/32/16/8)
is scored in one open-loop pass — prediction from *source* neighbors, so
each depth is a single full-frame tensor step on the torch device — and
the partition follows by bottom-up dynamic programming over the square
tree with an RD cost ``dist + lambda * rate``.

All depths are issued before any is fetched, so the card works through
them back to back. The final encode pass (wavefront) re-decides modes
closed-loop on the chosen leaves; this module only fixes the tree shape.
"""

from __future__ import annotations

import os

import numpy as np

from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.ops import intra as intra_ops
from svt_av1_tpu_torch.ops import quant as quant_ops
from svt_av1_tpu_torch.ops.device_md import decide_cost_issue, satd_modes
from svt_av1_tpu_torch.pipeline import avail, common, md


def rd_lambda(qindex: int, bit_depth: int = 8) -> float:
    """RD multiplier from qindex (shape follows av1_compute_rd_mult:
    lambda ~ q_step^2; constant calibrated on synthetic sweeps).
    SVT_TPU_LAMBDA_SCALE (env) rescales for calibration experiments, as
    in the JAX package."""
    q = quant_ops.dc_quant(qindex, 0, bit_depth) / 8.0
    scale = float(os.environ.get("SVT_TPU_LAMBDA_SCALE", "1"))
    return 0.1 * scale * q * q


def lane_lambdas(qv, bit_depth: int = 8) -> np.ndarray:
    """Per-lane RD lambdas of per-lane qindexes (adaptive quantization)."""
    lam = {int(q): rd_lambda(int(q), bit_depth) for q in np.unique(qv)}
    return np.array([lam[int(q)] for q in qv])


def _block_grid(w_eff: int, h_eff: int, size: int):
    """Top-left coords of all size-aligned blocks with origin inside the
    mi area."""
    xs = np.arange(0, w_eff, size)
    ys = np.arange(0, h_eff, size)
    gx, gy = np.meshgrid(xs, ys)
    return gx.reshape(-1), gy.reshape(-1)


def _depth_inputs(src, xs, ys, size, max_w: int, max_h: int,
                  mi_cols: int, mi_rows: int, bd: int = 8):
    """Host inputs of one depth's open-loop analysis: the blocks' source
    pixels [B, h, w], their source-pixel prediction edges (offset-1
    above / left arrays) and above / left availability."""
    bw, bh = common.leaf_wh(size)
    ha, hl = ys > 0, xs > 0
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    htr = avail.has_top_right_wh_vec(ys >> 2, xs >> 2, bw >> 2,
                                     bh >> 2, mi_cols)
    hbl = avail.has_bottom_left_wh_vec(ys >> 2, xs >> 2, bw >> 2,
                                       bh >> 2, mi_rows)
    above1, left1 = intra_ops.prepare_edges_av1(
        src, xs, ys, bw, bh, ha, hl, htr, hbl, bd=bd,
        max_w=max_w, max_h=max_h)
    iy = ys[:, None, None] + np.arange(bh)[None, :, None]
    ix = xs[:, None, None] + np.arange(bw)[None, None, :]
    return src[iy, ix].astype(np.int64), above1, left1, ha, hl


def _analyze_depth_issue(src, xs, ys, size, cands, qp, max_w: int,
                         max_h: int, mi_cols: int, mi_rows: int,
                         lam: float, bd: int = 8, device="cuda"):
    """Open-loop analysis of all blocks at one depth: host edge prep and
    one decide-cost issue on ``device`` (device_md.decide_cost_issue).
    Returns a handle; resolve it with _analyze_depth_fetch AFTER issuing
    every depth. ``size``: int (square) or (w, h) rect."""
    ins = _depth_inputs(src, xs, ys, size, max_w, max_h, mi_cols, mi_rows,
                        bd)
    cost = decide_cost_issue(0, *ins, cands, qp, size, lam, bd=bd,
                             device=device)
    return cost, lam


def _analyze_depth_fetch(handle):
    """rd_cost [B] float64 of one issued depth, plus the per-leaf syntax
    floor: skip + partition share + chroma mode and coefficient overhead
    invisible to this luma-only open-loop score (~16 bits). rd_cost is
    integer q9-scaled (md.rdcost); the DP continues in float64, which is
    exact for these magnitudes (< 2^53)."""
    cost, lam = handle
    return cost.cpu().numpy().astype(np.float64) \
        + lam * float(16 << md.RATE_Q)


# Per-leaf fixed syntax overhead (bits) of the SATD intra DP model: the
# JAX package's default (its SVT_TPU_DP_INTRA_OVERHEAD calibration knob is
# not carried over).
DP_INTRA_OVERHEAD_BITS = 24.0


def _analyze_depth_satd_issue(src, xs, ys, size, modes, max_w: int,
                              max_h: int, mi_cols: int, mi_rows: int,
                              lam: float, qstep: float, bd: int = 8,
                              device="cuda"):
    """SATD-scored open-loop depth (the reference's OIS model): host edge
    prep and one issue of the min-over-modes Hadamard SATD on ``device``
    (device_md.satd_modes). Returns a handle for
    _analyze_depth_satd_fetch."""
    ins = _depth_inputs(src, xs, ys, size, max_w, max_h, mi_cols, mi_rows,
                        bd)
    return (satd_modes(*ins, modes, size, bd, device=device), size, lam,
            qstep)


def _analyze_depth_satd_fetch(handle):
    """Depth cost [B] from an issued SATD (plain-bit rate scale, the same
    quantization-aware model family as choose_partition_inter's
    rd_model), in NumPy float64 like the JAX package: SSE estimated from
    the Hadamard L1 (transform gain sqrt(Ntx) per axis), a distortion
    floor and an R(D) curve."""
    satd, size, lam, qstep = handle
    satd = satd.cpu().numpy()
    bw, bh = common.leaf_wh(size)
    n = float(bw * bh)
    ntx = float(min(bw, 32) * min(bh, 32))
    sse = 1.5 * (satd.astype(np.float64) ** 2) / (ntx * n)
    nq = n * qstep * qstep
    dist = np.minimum(sse, sse * 0.05 + 0.125 * nq)
    rate = DP_INTRA_OVERHEAD_BITS + 0.6 * n * np.log2(1.0 + sse / nq)
    return dist + lam * rate


def _leaves_from_choices(choice: dict, min_size: int, mi_rows: int,
                         mi_cols: int) -> dict:
    """Materialize a DP decision grid into the leaf map. Kind encoding:
    0 NONE, 1 SPLIT, 2 HORZ, 3 VERT, 4 HORZ_4, 5 VERT_4, 6 HORZ_A,
    7 HORZ_B, 8 VERT_A, 9 VERT_B."""
    leaves = {}

    def walk(r, c, size):  # r, c in mi units
        if r >= mi_rows or c >= mi_cols:
            return
        hbs = size >> 3
        crosses = (r + hbs) >= mi_rows or (c + hbs) >= mi_cols
        kind = 1  # split
        if not (crosses and size > 8):
            if size <= min_size:
                kind = 0
            elif size in choice:
                kind = int(choice[size][(r * 4) // size,
                                        (c * 4) // size])
        if kind == 0:
            leaves[(r, c)] = size
            return
        half = size // 2
        if kind == 2:      # HORZ
            leaves[(r, c)] = (size, half)
            if r + hbs < mi_rows:
                leaves[(r + hbs, c)] = (size, half)
            return
        if kind == 3:      # VERT
            leaves[(r, c)] = (half, size)
            if c + hbs < mi_cols:
                leaves[(r, c + hbs)] = (half, size)
            return
        if kind in (4, 5):  # HORZ_4 / VERT_4
            qbs = size >> 4
            wh = (size, size // 4) if kind == 4 else (size // 4, size)
            for i in range(4):
                rr = r + (i * qbs if kind == 4 else 0)
                cc = c + (0 if kind == 4 else i * qbs)
                if rr < mi_rows and cc < mi_cols:
                    leaves[(rr, cc)] = wh
            return
        if kind in (6, 7, 8, 9):  # T-shapes: 2 squares + 1 rect half
            rh, rv = (size, half), (half, size)
            pat = {6: [((0, 0), half), ((0, hbs), half), ((hbs, 0), rh)],
                   7: [((0, 0), rh), ((hbs, 0), half), ((hbs, hbs), half)],
                   8: [((0, 0), half), ((hbs, 0), half), ((0, hbs), rv)],
                   9: [((0, 0), rv), ((0, hbs), half),
                       ((hbs, hbs), half)]}[kind]
            for (dr, dc), v in pat:
                if r + dr < mi_rows and c + dc < mi_cols:
                    leaves[(r + dr, c + dc)] = v
            return
        walk(r, c, half)
        walk(r, c + hbs, half)
        walk(r + hbs, c, half)
        walk(r + hbs, c + hbs, half)

    for sb_r in range(0, mi_rows, 16):
        for sb_c in range(0, mi_cols, 16):
            walk(sb_r, sb_c, 64)
    return leaves


def choose_partition(y_plane: np.ndarray, cfg: EncoderConfig,
                     mi_cols: int, mi_rows: int):
    """Returns the chosen leaf set {(mi_row, mi_col): size} for the frame.

    DP over the square tree: split iff sum of child costs + split syntax
    < leaf cost. Edge-crossing blocks are forced to split (the emit rule).
    """
    lam = rd_lambda(cfg.base_q_idx, cfg.bit_depth)
    src = common.pad_to_multiple(y_plane, 64).astype(np.int32)
    w_eff, h_eff = mi_cols * 4, mi_rows * 4
    qp = quant_ops.make_quant_params(cfg.base_q_idx,
                                     bit_depth=cfg.bit_depth)
    # the DP's open-loop scores only shape the tree; a trimmed candidate
    # set (no angle sweep, core modes) keeps the estimates faithful at a
    # fraction of the cost — the final encode re-decides closed-loop with
    # the full configured set
    cands = [c for c in common.intra_candidates(cfg)
             if c[1] == 0 and c[0] in (0, 1, 2, 3, 7, 9, 12)]
    if not cands:
        cands = common.intra_candidates(cfg)
    # SATD scoring (reference OIS model): swaps the per-depth full-T/Q
    # loop for Hadamard-residual costs in the plain-bit rate scale — the
    # DP only needs relative costs
    satd_mode = cfg.intra_dp_satd
    qstep = quant_ops.ac_quant(cfg.base_q_idx, 0, cfg.bit_depth) / 8.0
    satd_cands = tuple(m for m, _ in cands)
    bitq = 1.0 if satd_mode else 512.0
    # issue EVERY depth/arm before fetching any result
    pending = []   # (handle, fetch, store-callback)

    def depth_cost(xs, ys, wh, store):
        if satd_mode:
            pending.append((_analyze_depth_satd_issue(
                src, xs, ys, wh, satd_cands, w_eff, h_eff, mi_cols,
                mi_rows, lam, qstep, cfg.bit_depth, device=cfg.device),
                _analyze_depth_satd_fetch, store))
        else:
            pending.append((_analyze_depth_issue(
                src, xs, ys, wh, cands, qp, w_eff, h_eff, mi_cols,
                mi_rows, lam, cfg.bit_depth, device=cfg.device),
                _analyze_depth_fetch, store))

    sizes = [s for s in (64, 32, 16, 8)
             if cfg.min_partition_size <= s <= cfg.max_partition_size]
    if 64 not in sizes:
        sizes = [64] + sizes  # tree root is always evaluated
    cost = {}
    for size in sizes:
        xs, ys = _block_grid(w_eff, h_eff, size)
        cols = (w_eff + size - 1) // size
        rows = (h_eff + size - 1) // size

        def st_sq(c, size=size, rows=rows, cols=cols):
            cost[size] = c.reshape(rows, cols)

        depth_cost(xs, ys, size, st_sq)

    # rectangular arms (PARTITION_HORZ / PARTITION_VERT): two half-blocks
    # per square node, evaluated at the node grid (min leaf dim 8 keeps
    # chroma >= 4x4)
    rect_cost = {}
    if cfg.enable_rect_partitions:
        for size in sizes[:-1]:
            if size < 16:
                continue
            half = size // 2
            cols = (w_eff + size - 1) // size
            rows = (h_eff + size - 1) // size
            gx, gy = _block_grid(w_eff, h_eff, size)
            quarter = size // 4
            arms = [("h", (size, half), [(0, 0), (0, half)]),
                    ("v", (half, size), [(0, 0), (half, 0)])]
            if size >= 32:
                # 4-way strips (PARTITION_HORZ_4 / VERT_4); parent >= 32
                # keeps the 4:1 children's chroma at >= 4 px per side
                arms += [("h4", (size, quarter),
                          [(0, i * quarter) for i in range(4)]),
                         ("v4", (quarter, size),
                          [(i * quarter, 0) for i in range(4)])]
            for key, wh, offs in arms:
                xs = np.concatenate([gx + dx for dx, _ in offs])
                ys = np.concatenate([gy + dy for _, dy in offs])
                # skip out-of-area sub-blocks cleanly (cost -> inf)
                ok = (xs + wh[0] <= ((w_eff + 63) // 64) * 64) \
                    & (ys + wh[1] <= ((h_eff + 63) // 64) * 64)
                sel = np.nonzero(ok)[0]

                def st_arm(cc, size=size, key=key, sel=sel, n_all=len(xs),
                           n=len(gx), rows=rows, cols=cols,
                           n_offs=len(offs)):
                    c = np.full(n_all, np.inf)
                    c[sel] = cc
                    halves = [c[i * n:(i + 1) * n].reshape(rows, cols)
                              for i in range(n_offs)]
                    rect_cost[(size, key)] = sum(halves)
                    if key in ("h", "v"):
                        # individual half grids feed the T-shape arms
                        rect_cost[(size, key + "0")] = halves[0]
                        rect_cost[(size, key + "1")] = halves[1]

                if len(sel):
                    depth_cost(xs[sel], ys[sel], wh, st_arm)
                else:
                    st_arm(np.zeros(0))
    for h, fetch, store in pending:
        store(fetch(h))

    # bottom-up DP. "crosses" must mirror the emit/_leaves rule exactly:
    # a block is forced to split when its HALF-point falls outside the mi
    # area (has_rows/has_cols, EncodePartitionAv1 EbEntropyCoding.c:950).
    min_size = sizes[-1]
    best = cost[min_size].copy()
    choice = {}
    split_bits = bitq  # partition symbol proxy (1 bit; q9 or plain)
    for size in reversed(sizes[:-1]):
        rows, cols = cost[size].shape
        ch_rows, ch_cols = best.shape
        cpad = np.pad(best, ((0, (-ch_rows) % 2), (0, (-ch_cols) % 2)))
        sum4 = (cpad[0::2, 0::2] + cpad[0::2, 1::2]
                + cpad[1::2, 0::2] + cpad[1::2, 1::2])
        sum4 = sum4[:rows, :cols] + lam * split_bits
        leaf_c = cost[size]
        ys_b = np.arange(rows)[:, None] * size
        xs_b = np.arange(cols)[None, :] * size
        crosses = ((ys_b + size // 2 >= h_eff)
                   | (xs_b + size // 2 >= w_eff))
        options = [(0, np.where(crosses, np.inf, leaf_c)),
                   (1, sum4)]
        if (size, "h") in rect_cost:
            rb = lam * (split_bits + bitq)
            options.append((2, np.where(crosses, np.inf,
                                        rect_cost[(size, "h")] + rb)))
            options.append((3, np.where(crosses, np.inf,
                                        rect_cost[(size, "v")] + rb)))
        if (size, "h4") in rect_cost:
            rb4 = lam * (split_bits + 2 * bitq)  # rarer symbol + 3 leaves
            options.append((4, np.where(crosses, np.inf,
                                        rect_cost[(size, "h4")] + rb4)))
            options.append((5, np.where(crosses, np.inf,
                                        rect_cost[(size, "v4")] + rb4)))
        if (size, "h0") in rect_cost and (size // 2) in cost:
            # T-shapes (HORZ_A/B, VERT_A/B): two child squares + one
            # rect half, reusing the child-depth and rect-half grids
            ch = cost[size // 2]
            chp = np.full((2 * rows, 2 * cols), np.inf)
            chp[:min(ch.shape[0], 2 * rows), :min(ch.shape[1], 2 * cols)] \
                = ch[:2 * rows, :2 * cols]
            tl, tr = chp[0::2, 0::2], chp[0::2, 1::2]
            bl, br = chp[1::2, 0::2], chp[1::2, 1::2]
            rbt = lam * (split_bits + 2 * bitq)  # symbol + 2 extra leaves
            tarms = [(6, tl + tr + rect_cost[(size, "h1")]),
                     (7, rect_cost[(size, "h0")] + bl + br),
                     (8, tl + bl + rect_cost[(size, "v1")]),
                     (9, rect_cost[(size, "v0")] + tr + br)]
            options += [(k, np.where(crosses, np.inf, v + rbt))
                        for k, v in tarms]
        stackc = np.stack([o[1] for o in options])
        pick = np.argmin(stackc, axis=0)
        choice[size] = np.array([o[0] for o in options])[pick]
        best = np.take_along_axis(stackc, pick[None], axis=0)[0]

    return _leaves_from_choices(choice, min_size, mi_rows, mi_cols)


# Per-leaf fixed syntax-overhead estimate (bits) in the inter partition
# DP's open-loop RD model. Calibrated in the JAX package's round 4: 160
# bits cut bits at every rung of its RA ladder at flat PSNR.
DP_LEAF_OVERHEAD = 160.0


def choose_partition_inter(cfg: EncoderConfig, mi_cols: int, mi_rows: int,
                           ref_pyr, src_pyr):
    """Square (and, with rect partitions, rect/4:1/T-shape) partition DP
    for inter frames from motion-compensated residual energy: per depth,
    full-pel ME and the SSE of the compensated block, all on the
    pyramids' device in one pass (device_inter.dp_all_dev), then a
    float64 open-loop RD model and the bottom-up DP on the host — the
    JAX package's choose_partition_inter on its device path.

    ref_pyr: the LAST reference's padded luma pyramid (full, 1/2, 1/4);
    src_pyr: the frame's source pyramid (the full level padded to 64)."""
    from svt_av1_tpu_torch.ops import device_inter as di
    lam = rd_lambda(cfg.base_q_idx, cfg.bit_depth)
    # quantizer step in pixel units (same scale as the SSE operands)
    qstep = quant_ops.ac_quant(cfg.base_q_idx, 0, cfg.bit_depth) / 8.0
    w_eff, h_eff = mi_cols * 4, mi_rows * 4
    ph, pw = (-(-h_eff // 64) * 64, -(-w_eff // 64) * 64)
    sizes = [s for s in (64, 32, 16, 8)
             if cfg.min_partition_size <= s <= cfg.max_partition_size]
    if 64 not in sizes:
        sizes = [64] + sizes

    def rd_model(sse, wh, mvs):
        """Quantization-aware open-loop RD estimate from full-pel SSE:
        distortion saturates at the coding floor ~N*qstep^2/12 and rate
        follows the Gaussian R(D) shape N*log2(1+SSE/(N*qstep^2)), so
        when residuals die after quantization the leaf-overhead term
        decides and the DP merges."""
        bw, bh = common.leaf_wh(wh)
        n = float(bw * bh)
        sse = np.asarray(sse, dtype=np.float64)
        nq = n * qstep * qstep
        mv_bits = 4.0 + 0.5 * (np.abs(mvs).sum(axis=1) > 0)
        dist = np.minimum(sse, sse * 0.05 + 0.125 * nq)
        rate = DP_LEAF_OVERHEAD + mv_bits \
            + 0.6 * n * np.log2(1.0 + sse / nq)
        return dist + lam * rate

    def arms_for(size):
        half, quarter = size // 2, size // 4
        arms = [("h", (size, half), ((0, 0), (0, half))),
                ("v", (half, size), ((0, 0), (half, 0)))]
        if size >= 32:
            arms += [("h4", (size, quarter),
                      tuple((0, i * quarter) for i in range(4))),
                     ("v4", (quarter, size),
                      tuple((i * quarter, 0) for i in range(4)))]
        return arms

    arm_spec = [(size, wh, offs) for size in sizes
                if cfg.enable_rect_partitions and size >= 16
                for (_, wh, offs) in arms_for(size)]
    dp_res = di.dp_all_dev(ref_pyr, src_pyr, w_eff, h_eff, sizes, arm_spec)
    cost = {}
    rect_cost = {}
    for size in sizes:
        xs, ys = _block_grid(w_eff, h_eff, size)
        rows = (h_eff + size - 1) // size
        cols = (w_eff + size - 1) // size
        mvs, sse = dp_res[size]
        cost[size] = rd_model(sse, size, mvs).reshape(rows, cols)
        if cfg.enable_rect_partitions and size >= 16:
            for key, wh, offs in arms_for(size):
                xs2 = np.concatenate([xs + dx for dx, _ in offs])
                ys2 = np.concatenate([ys + dy for _, dy in offs])
                ok = (xs2 + wh[0] <= pw) & (ys2 + wh[1] <= ph)
                amvs, asse = dp_res[(size, tuple(wh))]
                c2 = np.where(ok, rd_model(asse, wh, amvs), np.inf)
                n = len(xs)
                halves = [c2[i * n:(i + 1) * n].reshape(rows, cols)
                          for i in range(len(offs))]
                rect_cost[(size, key)] = sum(halves)
                if key in ("h", "v"):
                    rect_cost[(size, key + "0")] = halves[0]
                    rect_cost[(size, key + "1")] = halves[1]

    min_size = sizes[-1]
    best = cost[min_size].copy()
    choice = {}
    for size in reversed(sizes[:-1]):
        rows, cols = cost[size].shape
        ch_rows, ch_cols = best.shape
        cpad = np.pad(best, ((0, (-ch_rows) % 2), (0, (-ch_cols) % 2)))
        sum4 = (cpad[0::2, 0::2] + cpad[0::2, 1::2]
                + cpad[1::2, 0::2] + cpad[1::2, 1::2])
        sum4 = sum4[:rows, :cols] + lam * 1.0
        ys_b = np.arange(rows)[:, None] * size
        xs_b = np.arange(cols)[None, :] * size
        crosses = ((ys_b + size // 2 >= h_eff)
                   | (xs_b + size // 2 >= w_eff))
        options = [(0, np.where(crosses, np.inf, cost[size])),
                   (1, sum4)]
        if (size, "h") in rect_cost:
            rb = lam * 2.0
            options.append((2, np.where(crosses, np.inf,
                                        rect_cost[(size, "h")] + rb)))
            options.append((3, np.where(crosses, np.inf,
                                        rect_cost[(size, "v")] + rb)))
        if (size, "h4") in rect_cost:
            rb4 = lam * 3.0  # rarer symbol + 3 extra leaves of overhead
            options.append((4, np.where(crosses, np.inf,
                                        rect_cost[(size, "h4")] + rb4)))
            options.append((5, np.where(crosses, np.inf,
                                        rect_cost[(size, "v4")] + rb4)))
        if (size, "h0") in rect_cost and (size // 2) in cost:
            # T-shapes: two child squares + one rect half
            ch = cost[size // 2]
            chp = np.full((2 * rows, 2 * cols), np.inf)
            chp[:min(ch.shape[0], 2 * rows), :min(ch.shape[1], 2 * cols)] \
                = ch[:2 * rows, :2 * cols]
            tl, tr = chp[0::2, 0::2], chp[0::2, 1::2]
            bl, br = chp[1::2, 0::2], chp[1::2, 1::2]
            rbt = lam * 2.0  # T symbol + 2 extra leaves of overhead
            tarms = [(6, tl + tr + rect_cost[(size, "h1")]),
                     (7, rect_cost[(size, "h0")] + bl + br),
                     (8, tl + bl + rect_cost[(size, "v1")]),
                     (9, rect_cost[(size, "v0")] + tr + br)]
            options += [(k, np.where(crosses, np.inf, v + rbt))
                        for k, v in tarms]
        stackc = np.stack([o[1] for o in options])
        pick = np.argmin(stackc, axis=0)
        choice[size] = np.array([o[0] for o in options])[pick]
        best = np.take_along_axis(stackc, pick[None], axis=0)[0]

    return _leaves_from_choices(choice, min_size, mi_rows, mi_cols)
