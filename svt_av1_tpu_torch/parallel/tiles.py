"""Multi-device encode over an explicit list of torch devices: the port of
the JAX package's ``parallel/tiles.py``.

AV1 tiles share no prediction and no entropy state, so each device runs
the uniform tile program (``ops.device_tile.make_tile_body``) on its own
tile. The two communication patterns of the JAX mesh program become plain
copies between devices:

- **halo exchange**: each device sends its rightmost 8 recon columns to
  the next device in the ring (the JAX ``ppermute``; here
  ``.to(devices[(i + 1) % n])``), the width the in-loop filters read
  across a tile seam;
- **stats reduction**: the per-tile sums of |luma levels| are summed in
  int64 on ``devices[0]`` (the JAX ``psum``).

The distributed deblocking filter cuts the frame into column strips, one
per device: each vertical seam edge is filtered from an 8-px halo of the
neighbour's pixels, the filtered overhang writes go back to the strip that
owns them, and the strip SSEs are summed on ``devices[0]`` before each
level is picked. The strip-sharded shape group fans an inter shape
group's blocks out by column strip, each strip's blocks on its device
against replicated references.

A device list may name one device several times (``["cpu"] * 8`` in the
tests, ``["cuda:0"] * 4`` on one card): each entry is then a separate
shard of the work, run in turn. Every function gives the integers of the
single-device encoder: the same integer programs run per shard, and the
injected results go through the serial encoder's filters and entropy.
The devices are an argument, as the JAX functions take a ``Mesh``; the
config's ``mesh_shape`` is read by nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from svt_av1_tpu_torch.config import EncoderConfig

HALO_W = 8      # filter halo width (DLF / CDEF / LR read <= 8 px)


def _device_list(devices) -> list:
    """torch devices; a CUDA device without a card raises."""
    from svt_av1_tpu_torch.pipeline.encoder import check_device
    devs = [check_device(str(d)) for d in devices]
    assert devs, "need at least one device"
    return devs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def encode_keyframe_tiles_sharded(y, u, v, cfg: EncoderConfig, devices,
                                  report=None):
    """Encode a key frame with one tile per entry of ``devices`` (equal
    tiles of uniform square leaves: ``fixed_partition_size`` set).

    Returns (tu_bytes, halo_ok, stats): halo_ok confirms that the halo
    each device received equals its left neighbour tile's right edge,
    stats is the frame's sum of |luma levels| over all tiles. With the
    intra edge filter active the serial encoder takes the per-wave loop
    and the tile results are not used (as in the JAX package), so
    halo_ok and stats then describe discarded work.

    ``report``: an optional dict that receives per tile its device, its
    program's seconds (the device synchronised around it) and the kernel
    launches inside it (``tiles``), how many tile results the serial
    encoder took (``injected``) and its display recon (``recon``)."""
    from svt_av1_tpu_torch.bitstream import obu
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_tile, step_graphs
    from svt_av1_tpu_torch.pipeline import common
    from svt_av1_tpu_torch.pipeline.wavefront import WavefrontIntraEncoder

    devs = _device_list(devices)
    n_dev = len(devs)
    assert cfg.fixed_partition_size is not None, \
        "the tile program needs a fixed partition size (uniform leaves)"
    enc = WavefrontIntraEncoder(cfg)
    frame_src = [common.pad_to_multiple(y, 64).astype(np.int32),
                 common.pad_to_multiple(u, 32).astype(np.int32),
                 common.pad_to_multiple(v, 32).astype(np.int32)]
    frame_recon = [np.zeros(p.shape, dtype=common.pixel_dtype(
        cfg.bit_depth)) for p in frame_src]
    tile_log2 = obu.clamp_tile_log2(enc.seq, cfg.tile_cols_log2,
                                    cfg.tile_rows_log2)
    rects = common.tile_rects(enc.seq.sb_cols, enc.seq.sb_rows,
                              enc.mi_cols, enc.mi_rows, *tile_log2)
    assert len(rects) == n_dev, \
        f"need one tile per device ({len(rects)} tiles, {n_dev} devices)"
    cands = common.intra_candidates(cfg)
    keys, args_list = [], []
    for rect in rects:
        enc._enter_tile(frame_src, frame_recon, rect)
        enc.leaf_sizes = enc._fixed_leaf_sizes(cfg.fixed_partition_size)
        enc.max_wh = [(enc.mi_cols * 4, enc.mi_rows * 4),
                      (enc.mi_cols * 2, enc.mi_rows * 2),
                      (enc.mi_cols * 2, enc.mi_rows * 2)]
        enc.leaf_index = {(r, c): i for i, (r, c, _) in
                          enumerate(enc._leaves())}
        meta = device_tile.tile_body_operands(enc, cands)
        assert meta is not None, "tiles must have uniform leaf maps"
        keys.append(meta[0])
        args_list.append(meta[1])
    assert len(set(keys)) == 1, "tiles must share one program shape"
    body = device_tile.make_tile_body(*keys[0])
    # one class-step runner per device: the tiles it runs share its graphs
    runners = {d: step_graphs.ClassGraphs() for d in devs}

    results, halos, tiles = [], [None] * n_dev, []
    for i, (d, args) in enumerate(zip(devs, args_list)):
        before = collections.Counter(dev.LAUNCHES)
        _sync(d)
        t0 = time.perf_counter()
        ry, ru, rv, out = body(*(torch.as_tensor(a).to(d) for a in args),
                               runner=runners[d])
        _sync(d)
        tiles.append({"device": str(d), "seconds": time.perf_counter() - t0,
                      "launches": dict(collections.Counter(dev.LAUNCHES)
                                       - before)})
        # halo exchange: my rightmost columns to the next device
        halos[(i + 1) % n_dev] = ry[:, -HALO_W:].to(devs[(i + 1) % n_dev])
        results.append((ry, ru, rv, out))
    # frame stats reduction on devices[0] (over every row of the
    # program's levels, as the JAX psum)
    stats = sum(out["qc_y"].abs().sum(dtype=torch.int64).to(devs[0])
                for _, _, _, out in results)
    halo_ok = all(torch.equal(halos[t].cpu(),
                              results[(t - 1) % n_dev][0][:, -HALO_W:].cpu())
                  for t in range(n_dev))

    # the serial encoder takes each tile's results in tile order (the
    # hook in place of its tile program) and runs the filters, entropy
    # and packaging as on one device
    it = iter(results)
    taken = []

    def inject(enc2, cands2):
        meta = device_tile.tile_metadata(enc2, cands2)
        assert meta is not None, "tiles must have uniform leaf maps"
        ry, ru, rv, out = next(it)
        n = len(enc2.leaf_index)
        ids = np.arange(n)
        small = torch.stack([out[k][:n].to(torch.int64)
                             for k in device_tile.TILE_BODY_KEYS[:10]])
        device_tile.inject_results(
            [[(meta, ids, 0)]], [ids],
            [(small,) + tuple(out[k][:n] for k in
                              device_tile.TILE_BODY_KEYS[10:])])
        device_tile.store_recon(enc2, (ry, ru, rv))
        taken.append(n)
        return True

    enc3 = WavefrontIntraEncoder(dataclasses.replace(cfg,
                                                     device=str(devs[0])))
    enc3._no_defer = True
    enc3.tile_hook = inject
    tu, recon, _ = enc3.encode(y, u, v)
    if report is not None:
        report.update(tiles=tiles, injected=len(taken), recon=recon)
    return tu, halo_ok, int(stats)


# --- distributed DLF: halo-consuming filter over column strips ----------------

def _pad_maps(maps):
    """2 ext units of horizontal padding, so every strip takes a
    (su + 4)-unit slice of the vertical-edge maps."""
    (txw, txh), sx, sy = maps
    return (np.pad(txw, ((0, 0), (2, 2)), mode="edge").astype(np.int32),
            np.pad(sx, ((0, 0), (2, 2))).astype(bool),
            np.asarray(txh, np.int32), np.asarray(sy, bool))


def _strip_filter(strips, maps, level: int, is_luma: bool, h_e: int,
                  sw_p: int, bd: int, devs) -> list:
    """One plane's DLF over its column strips: the vertical pass of each
    strip on its 8-px neighbour halos (the frame's outer edges
    replicate), the filtered overhang writes merged back into their
    owners, then the strip-local horizontal pass. Equal to
    ``ops.device._dlf_filter_plane_j`` on the whole plane."""
    from svt_av1_tpu_torch.ops.device import _dlf_dir_pass_j, const
    n = len(strips)
    su = sw_p // 4
    txw_ep, sx_ep, txh, sy = maps
    lvl = [torch.tensor(level, dtype=torch.int32, device=d) for d in devs]
    outs, changed = [], []
    for i, (s, d) in enumerate(zip(strips, devs)):
        left = strips[i - 1][:, -8:].to(d) if i > 0 \
            else s[:, :1].expand(-1, 8)
        right = strips[i + 1][:, :8].to(d) if i < n - 1 \
            else s[:, -1:].expand(-1, 8)
        ext = torch.cat([left, s, right], dim=1)
        off = i * su
        # edges this strip owns: its own units' left edges, but not the
        # frame's column 0
        sx_s = sx_ep[:, off:off + su + 4].copy()
        sx_s[:, :2] = False
        sx_s[:, 2 + su:] = False
        if i == 0:
            sx_s[:, 2] = False
        out = _dlf_dir_pass_j(ext, const(txw_ep[:, off:off + su + 4], d),
                              const(sx_s, d), lvl[i], is_luma,
                              4 * (su + 4), h_e, bd)
        outs.append(out)
        changed.append(out != ext)
    works = []
    for i, d in enumerate(devs):
        work = outs[i][:, 8:8 + sw_p].clone()
        if i < n - 1:       # the right neighbour's writes into my columns
            w8 = work[:, -8:]
            work[:, -8:] = torch.where(changed[i + 1][:, :8].to(d),
                                       outs[i + 1][:, :8].to(d), w8)
        if i > 0:           # the left neighbour's
            w8 = work[:, :8]
            work[:, :8] = torch.where(changed[i - 1][:, -8:].to(d),
                                      outs[i - 1][:, -8:].to(d), w8)
        off = i * su
        work = _dlf_dir_pass_j(
            work.t(), const(np.ascontiguousarray(txh[:, off:off + su].T), d),
            const(np.ascontiguousarray(sy[:, off:off + su].T), d), lvl[i],
            is_luma, h_e, 4 * su, bd).t()
        works.append(work.clamp(0, (1 << bd) - 1))
    return works


def dlf_search_apply_sharded(recon_planes, src_planes, leaf_sizes,
                             mi_rows, mi_cols, qindex: int, bd: int,
                             devices):
    """DLF level search + apply with the frame cut into one column strip
    per entry of ``devices``: the same candidate levels and first-minimum
    scan as ``ops.dlf.pick_levels`` + ``loop_filter_frame`` (host) and
    ``ops.device.dlf_search_apply_dev``, the same integer filters (with
    the host's bit-depth scaled thresholds at 10 bits). The planes are
    the display-size recon and source (numpy or tensors); the width must
    be the mi width and a multiple of 8 strips. Returns ([y, u, v]
    filtered numpy planes, (ly, ly, luv, luv))."""
    from svt_av1_tpu_torch.ops import dlf
    devs = _device_list(devices)
    n_dev = len(devs)
    H, W = tuple(recon_planes[0].shape)
    w_eff, h_eff = mi_cols * 4, mi_rows * 4
    assert W == w_eff and W % (8 * n_dev) == 0, \
        "sharded DLF needs width == padded width, strips %8==0"
    sw = W // n_dev
    g = dlf.level_guess(qindex, bd)
    cl = sorted({0, max(0, g // 2), g, min(63, (3 * g) // 2)})
    cands = (cl + [cl[-1]] * 4)[:4]
    ymaps = _pad_maps(dlf.build_tx_maps(leaf_sizes, mi_rows, mi_cols, 0))
    cmaps = _pad_maps(dlf.build_tx_maps(leaf_sizes, mi_rows, mi_cols, 1))

    def strips(plane, w):
        t = plane if isinstance(plane, torch.Tensor) \
            else torch.from_numpy(np.asarray(plane).astype(np.int32))
        return [t[:, i * w:(i + 1) * w].to(d, torch.int32)
                for i, d in enumerate(devs)]

    rec = [strips(recon_planes[0], sw), strips(recon_planes[1], sw // 2),
           strips(recon_planes[2], sw // 2)]
    src = [strips(src_planes[0], sw), strips(src_planes[1], sw // 2),
           strips(src_planes[2], sw // 2)]
    geo = [(ymaps, True, h_eff, sw), (cmaps, False, h_eff // 2, sw // 2),
           (cmaps, False, h_eff // 2, sw // 2)]

    def filtered(p, level):
        maps, is_luma, h_e, sw_p = geo[p]
        return _strip_filter(rec[p], maps, level, is_luma, h_e, sw_p, bd,
                             devs)

    def sse(p, outs):
        """The strip SSEs of plane p, summed on devices[0]."""
        h_e = geo[p][2]
        return sum(((a[:h_e].to(torch.int64) - b[:h_e].to(torch.int64))
                    ** 2).sum().to(devs[0]) for a, b in zip(outs, src[p]))

    ysses, csses = [], []
    for level in cands:
        ysses.append(sse(0, filtered(0, level)))
        csses.append(sse(1, filtered(1, level)) + sse(2, filtered(2, level)))
    ly = cands[int(torch.argmin(torch.stack(ysses)))]
    luv = cands[int(torch.argmin(torch.stack(csses)))] if ly > 0 else 0
    pix = np.uint8 if bd <= 8 else np.uint16
    planes = [torch.cat([s.to(devs[0]) for s in filtered(p, lv)], dim=1)
              .cpu().numpy().astype(pix)
              for p, lv in ((0, ly), (1, luv), (2, luv))]
    levels = (0, 0, 0, 0) if ly == 0 else (ly, ly, luv, luv)
    return planes, levels


# --- strip-sharded inter shape group ------------------------------------------

def make_sharded_shape_group_issue(devices, strip_w: int, report=None):
    """A drop-in for ``ops.device_inter.shape_group_issue`` (its whole
    signature and its 15 outputs) that fans a shape group's blocks out by
    column strip, one strip of ``strip_w`` luma columns per entry of
    ``devices``: each strip's blocks run ``device_inter.shape_group`` on
    its device against replicated references and a copy of the recon
    planes, the decisions come back in the caller's block order, and each
    strip's recon columns are written back into the caller's planes in
    place. The recon width must be ``len(devices) * strip_w`` and
    ``strip_w`` a multiple of 64, so that every block lies inside one
    strip. A strip with no blocks runs nothing. Pass it to
    ``pipeline.encoder.Encoder`` or ``encode_ivf`` as
    ``shape_group_issue``.

    ``report``: an optional dict whose ``strips`` list receives per strip
    its device and, summed over the calls, its shape groups, blocks and
    the kernel launches inside its work."""
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_inter as di
    from svt_av1_tpu_torch.ops.device import const
    from svt_av1_tpu_torch.ops.device_md import quant_vectors

    devs = _device_list(devices)
    n_dev = len(devs)
    if strip_w <= 0 or strip_w % 64:
        raise ValueError(f"strip_w {strip_w}: strips must hold whole "
                         "64-px blocks")
    strips = [{"device": str(d), "groups": 0, "blocks": 0,
               "launches": collections.Counter()} for d in devs]
    if report is not None:
        report["strips"] = strips

    def issue(recon_planes, ref_pyrs_list, refs_u, refs_v, src_pyr,
              src_u, src_v, xs, ys, size, qp, lam, fwd_pos, bwd_pos, bd=8,
              rdoq=False, qv=None, lamv=None, filter_search=False,
              tx_search=False):
        b = len(xs)
        xs = np.asarray(xs, np.int64)
        ys = np.asarray(ys, np.int64)
        if recon_planes[0].shape[1] != n_dev * strip_w:
            raise ValueError(f"{n_dev} strips of {strip_w} do not tile the "
                             f"recon width {recon_planes[0].shape[1]}")
        strip = xs // strip_w
        order = np.argsort(strip, kind="stable")
        counts = np.bincount(strip, minlength=n_dev)
        qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)
        home = recon_planes[0].device
        per_strip, pos = [], 0
        for i, (d, k) in enumerate(zip(devs, counts.tolist())):
            sel = order[pos:pos + k]
            pos += k
            if not k:
                continue
            before = collections.Counter(dev.LAUNCHES)
            rec = [p.to(d, copy=True) for p in recon_planes]
            outs = di.shape_group(
                rec, [tuple(p.to(d) for p in pyr) for pyr in ref_pyrs_list],
                torch.stack([p.to(d) for p in refs_u]),
                torch.stack([p.to(d) for p in refs_v]),
                tuple(p.to(d) for p in src_pyr), src_u.to(d), src_v.to(d),
                const(xs[sel], d), const(ys[sel], d), size,
                const(qvec[sel], d), const(lamqv[sel], d), tuple(fwd_pos),
                tuple(bwd_pos), bd, rdoq, filter_search, tx_search)
            for p, ss in ((0, 0), (1, 1), (2, 1)):
                c0, c1 = (i * strip_w) >> ss, ((i + 1) * strip_w) >> ss
                recon_planes[p][:, c0:c1] = rec[p][:, c0:c1].to(home)
            per_strip.append([o.to(home) for o in outs])
            strips[i]["groups"] += 1
            strips[i]["blocks"] += k
            strips[i]["launches"].update(collections.Counter(dev.LAUNCHES)
                                         - before)
        inv = np.empty(b, dtype=np.int64)
        inv[order] = np.arange(b)
        inv = const(inv, home)
        dec = tuple(torch.cat(parts)[inv] for parts in zip(*per_strip))
        return recon_planes, dec, b

    return issue
