"""On-card checks of the PyTorch port: the quantization kernel in both
modes (quantize-only and the fused quantize + RDOQ-lite trim + rate)
against its plain versions, launch counts, tie-breaks on CUDA, and the
encoder on ``cuda`` against the same encoder on the CPU.

Every test needs a CUDA device and skips without one (marker ``cuda``).
The file imports nothing of JAX, so it also runs on a GPU machine without
JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops import device_md as tmd
from svt_av1_tpu_torch.ops import quant as quant_ops
from svt_av1_tpu_torch.utils.blocks import TX_4X4, TX_16X16, get_scan
from tests.torch_quant_cases import (ROW_LENGTHS, TIE_ROWS, stage_case,
                                     stage_rows, tx_size_for)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(n, seed, b):
    rng = np.random.default_rng(seed)
    coeff = rng.integers(-(1 << 17), (1 << 17) + 1, (b, n)).astype(np.int32)
    for i, v in enumerate((0, 32767, -32767, 1 << 20, -(1 << 20))):
        coeff[i] = v
    qv = rng.integers(0, 256, b).astype(np.int32)
    qv[:2] = (0, 255)
    return coeff, qv


@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_quantize_qv_kernel_matches_plain(cuda, n):
    for ls in (0, 1, 2):
        scan = get_scan(tx_size_for(n, ls), 0)
        coeff, qv = _case(n, seed=3 * n + ls, b=1001)
        c = torch.as_tensor(coeff, device=cuda)
        q = torch.as_tensor(qv, device=cuda)
        before = dev.LAUNCHES["quantize_qv"]
        got = dev.quantize_qv(c, scan, q, ls, 8)
        assert dev.LAUNCHES["quantize_qv"] == before + 1
        want = dev.quantize_qv_plain(c, scan, q, ls, 8)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        cpu = dev.quantize_qv(torch.as_tensor(coeff), scan,
                              torch.as_tensor(qv), ls, 8)
        for g, w in zip(got, cpu):
            assert torch.equal(g.cpu(), w)


def test_quantize_qv_kernel_refuses_bad_operands(cuda):
    scan = get_scan(TX_4X4, 0)
    c = torch.zeros((3, 16), dtype=torch.int32, device=cuda)
    q = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dev.quantize_qv(c.to(torch.int64), scan, q, 0, 8)
    with pytest.raises(ValueError):
        dev.quantize_qv(c, scan, q.to(torch.int64), 0, 8)
    with pytest.raises(ValueError):
        dev.quantize_qv(c[:, :8], scan[:8], q, 0, 8)
    with pytest.raises(ValueError):
        dev.quantize_qv(torch.zeros((16, 3), dtype=torch.int32,
                                    device=cuda).t(), scan, q, 0, 8)
    q_, _, eob = dev.quantize_qv(c[:0], scan, q[:0], 0, 8)
    assert q_.shape == (0, 16) and eob.shape == (0,)


@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_quant_stage_kernel_matches_plain(cuda, n):
    """Both modes of the kernel against their plain versions on the card
    and on the CPU, exact, over log_scale, plane type, RDOQ on/off and
    B in {0, 1, 8, 37, 1001}; each call with rows is one launch."""
    for ls in (0, 1, 2):
        for b in (0, 1, 8, 37, 1001):
            coeff, qv, lam, scan, tx = stage_rows(n, ls, b, 7 * n + ls + b)
            c, q, lm = (torch.as_tensor(a, device=cuda)
                        for a in (coeff, qv, lam))
            before = dev.LAUNCHES["quantize_qv"]
            got = dev.quantize_qv(c, scan, q, ls, 8)
            assert dev.LAUNCHES["quantize_qv"] == before + (b > 0)
            want = dev.quantize_qv_plain(c, scan, q, ls, 8)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            for plane_type in (0, 1):
                for rl, mode in ((None, "quant_stage"),
                                 (lm, "quant_stage_rdoq")):
                    before = dev.LAUNCHES[mode]
                    got = tmd.quant_stage_j(c, scan, q, ls, 8, tx,
                                            plane_type, rl)
                    assert dev.LAUNCHES[mode] == before + (b > 0)
                    want = tmd.quant_stage_plain(c, scan, q, ls, 8, tx,
                                                 plane_type, rl)
                    cpu = tmd.quant_stage_j(
                        torch.as_tensor(coeff), scan, torch.as_tensor(qv),
                        ls, 8, tx, plane_type,
                        None if rl is None else torch.as_tensor(lam))
                    for g, w, h in zip(got, want, cpu):
                        assert g.dtype == w.dtype and g.shape == w.shape
                        assert torch.equal(g, w)
                        assert torch.equal(g.cpu(), h)


@pytest.mark.parametrize("n", [32, 128, 512])
def test_rect_row_lengths_at_frame_batches(cuda, n):
    """The rectangular transforms' row lengths (4x8/8x4, 8x16/16x8,
    16x32 up to 64x16) in all three modes at B = 1, 37 and 8160, exact
    against the plain versions."""
    for ls in (0, 1, 2):
        for b in (1, 37, 8160):
            coeff, qv, lam, scan, tx = stage_rows(n, ls, b, 3 * n + ls + b)
            c, q, lm = (torch.as_tensor(a, device=cuda)
                        for a in (coeff, qv, lam))
            for g, w in zip(dev.quantize_qv(c, scan, q, ls, 8),
                            dev.quantize_qv_plain(c, scan, q, ls, 8)):
                assert torch.equal(g, w)
            for plane_type in (0, 1):
                for rl in (None, lm):
                    got = tmd.quant_stage_j(c, scan, q, ls, 8, tx,
                                            plane_type, rl)
                    want = tmd.quant_stage_plain(c, scan, q, ls, 8, tx,
                                                 plane_type, rl)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype and torch.equal(g, w)


def test_full_loop_pass_is_one_launch_on_card(cuda):
    """One full-loop pass (luma, one tx type, one candidate) launches the
    fused kernel once and nothing else of the quantizer."""
    rng = np.random.default_rng(1)
    b = 9
    srcs = rng.integers(0, 256, (b, 16, 16))
    edges = rng.integers(0, 256, (b, 33)).astype(np.int32)
    ha = np.ones(b, bool)
    qp = quant_ops.make_quant_params(70)
    before = dict(dev.LAUNCHES)
    tmd.decide_block_batch_dev(0, srcs, edges, edges, ha, ha, [(0, 0)], qp,
                               16, 30.0, nfl=1, rdoq=True, device="cuda")
    assert dev.LAUNCHES["quant_stage_rdoq"] == \
        before.get("quant_stage_rdoq", 0) + 1
    for mode in ("quant_stage", "quantize_qv"):
        assert dev.LAUNCHES[mode] == before.get(mode, 0)


def test_quant_stage_refuses_bad_operands(cuda):
    coeff, qv, lam, scan, tx = stage_case(64, 0, 12, 3)
    c, q, lm = (torch.as_tensor(a, device=cuda) for a in (coeff, qv, lam))
    with pytest.raises(ValueError):
        tmd.quant_stage_j(c, scan, q, 0, 8, tx, 0, lm.to(torch.int32))
    with pytest.raises(ValueError):
        tmd.quant_stage_j(c, scan, q, 0, 8, tx, 0, lm[:5])
    buf = torch.zeros(c.numel() + 4, dtype=torch.int32, device=cuda)
    misaligned = buf[1:1 + c.numel()].view(c.shape)     # 4 B past 16 B
    misaligned.copy_(c)
    with pytest.raises(ValueError):
        tmd.quant_stage_j(misaligned, scan, q, 0, 8, tx, 0, lm)


def test_fast_cost_tie_keeps_candidate_order_on_card(cuda):
    """V and H tie in the fast loop (flat edges, lambda q 1): the stable
    argsort keeps the first-listed mode on the card as on the CPU."""
    b = 300
    srcs = np.full((b, 16, 16), 90, np.int64)
    srcs[:, 8:] = 140
    edges = np.full((b, 33), 120, np.int32)
    ha = np.ones(b, bool)
    qp = quant_ops.make_quant_params(100)
    for cands, want_mode in (([(2, 0), (1, 0)], 2), ([(1, 0), (2, 0)], 1)):
        outs = [tmd.decide_block_batch_dev(0, srcs, edges, edges, ha, ha,
                                           cands, qp, 16, 0.001, nfl=1,
                                           device=d)
                for d in ("cuda", "cpu")]
        assert outs[0][0].tolist() == [want_mode] * b
        for g, w in zip(*outs):
            assert np.array_equal(g, w)


def test_rdoq_first_minimum_on_card(cuda):
    """rdoq_trim_j's argmin keeps the first of equal trim costs on CUDA:
    zero-lambda rows make every candidate eob past the last nonzero
    coefficient cost the same."""
    scan = get_scan(TX_16X16, 0)
    rng = np.random.default_rng(2)
    b = 64
    qc = np.zeros((b, 256), np.int32)
    qc[:, scan[:5]] = rng.integers(1, 4, (b, 5))
    dq = qc * 40
    eob = np.full(b, 9, np.int32)             # 4 trailing zeros in scan
    qv = np.full(b, 120, np.int32)
    lam = np.zeros(b, np.int64)
    outs = []
    for d in ("cuda", "cpu"):
        T = (lambda a, d=d: torch.as_tensor(a, device=d))
        outs.append([t.cpu() for t in tmd.rdoq_trim_j(
            T(qc), T(dq), T(eob), scan, TX_16X16, T(qv), 0, T(lam))])
    assert outs[0][2].tolist() == [5] * b
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    # the fused kernel: level-1 rows at qindex 1 and lambda 0 cost the
    # same at every candidate eob, so the first minimum is eob 0
    for n, ls in ((16, 1), (64, 2), (256, 1)):
        coeff, qv, lam, scan, tx = stage_case(n, ls, 12, n + ls)
        outs = []
        for d in ("cuda", "cpu"):
            T = (lambda a, d=d: torch.as_tensor(a, device=d))
            outs.append([t.cpu() for t in tmd.quant_stage_j(
                T(coeff), scan, T(qv), ls, 8, tx, 0, T(lam))])
        rows = list(TIE_ROWS)
        assert outs[0][2][rows].tolist() == [0] * len(rows)
        for g, w in zip(*outs):
            assert torch.equal(g, w)


def test_fused_frame_program_on_card_equals_cpu(cuda):
    """The frame-batched keyframe program (4 tile columns at 448x128) on
    cuda, its class steps replayed as CUDA graphs, equals it on the CPU:
    every tile's decisions, eobs and coefficients, and the recon
    planes."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.utils.clip import make_clip
    from tests.torch_tile_cases import assert_same_state, keyframe_state
    frame = make_clip(w=448, h=128, frames=1, seed=3)[0]
    runs = []
    orig = tdt.run_tiles_fused

    def spy(enc, metas, *a):
        runs.append(len(metas))
        out = orig(enc, metas, *a)
        stats.append(enc.fused_stats)
        return out

    stats = []
    tdt.run_tiles_fused = spy
    try:
        got, want = (keyframe_state(frame, dataclasses.replace(
            preset_config(width=448, height=128, preset=5, intra_period=0,
                          tile_columns=2, device=d), enable_dlf=False))
            for d in ("cuda", "cpu"))
    finally:
        tdt.run_tiles_fused = orig
    assert runs == [4, 4]
    assert_same_state(got, want)
    # on the card every class step replayed or captured a graph
    card = stats[0]
    assert card["graph_replays"] + card["graph_captures"] == \
        card["class_steps"] == stats[1]["class_steps"]
    assert card["graph_captures"] and card["graph_replays"]


def test_fused_wave_loop_never_syncs(cuda):
    """The fused program's wave loop runs under
    torch.cuda.set_sync_debug_mode("error"): no operation inside it waits
    for the card (a first run fills the constant caches)."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.utils.clip import make_clip
    from tests.torch_tile_cases import keyframe_state
    frame = make_clip(w=448, h=128, frames=1, seed=3)[0]
    cfg = preset_config(width=448, height=128, preset=5, intra_period=0,
                        tile_columns=2, device="cuda")
    keyframe_state(frame, cfg)
    orig = tdt.make_mixed_tile_body
    ran = []

    def checked(*a, **k):
        prog = orig(*a, **k)

        def run(*pa):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = prog(*pa)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ran.append(out[2])
            return out
        return run

    tdt.make_mixed_tile_body = checked
    try:
        keyframe_state(frame, cfg)
    finally:
        tdt.make_mixed_tile_body = orig
    assert len(ran) == 1 and ran[0] > 0


def _graphed_intra(frames, device, encoders=1):
    """All-intra preset 5 at 848x480 through ``encoders`` Encoders in
    turn on ``device``: per Encoder its TUs, and per key frame its
    program's counts (``fused_stats``), the calls into
    ``device_md.quant_stage_j`` inside the program and the (class, lane
    bucket) keys its class steps met; and the Encoders."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.ops import step_graphs
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    cfg = preset_config(width=848, height=480, preset=5, intra_period=0,
                        device=device)
    frame, calls = [], [0]
    saved = (tdt._run_program, tmd.quant_stage_j, step_graphs.ClassGraphs.step)

    def program(enc, *a):
        calls[0] = 0
        frame.append({"keys": set()})
        before = sum(dev.LAUNCHES.values())
        out = saved[0](enc, *a)
        frame[-1].update(stats=dict(enc.fused_stats), quant_calls=calls[0],
                         launches=sum(dev.LAUNCHES.values()) - before)
        return out

    def quant(*a, **k):
        calls[0] += 1
        return saved[1](*a, **k)

    def step(self, stage, key, recon, src, lanes, off, n):
        frame[-1]["keys"].add((key[0], step_graphs.lane_bucket(n)))
        return saved[2](self, stage, key, recon, src, lanes, off, n)

    tdt._run_program, tmd.quant_stage_j = program, quant
    step_graphs.ClassGraphs.step = step
    runs = []
    try:
        for _ in range(encoders):
            enc, tus, frame[:] = Encoder(cfg), [], []
            for f in frames:
                enc.send_picture(*f)
                while (pkt := enc.get_packet()) is not None:
                    tus.append(pkt[0])
            enc.flush()
            while (pkt := enc.get_packet()) is not None:
                tus.append(pkt[0])
            runs.append((tus, list(frame), enc))
    finally:
        (tdt._run_program, tmd.quant_stage_j,
         step_graphs.ClassGraphs.step) = saved
    return runs


def test_graphed_class_steps_on_card_equal_cpu(cuda):
    """2 frames of 848x480 all-intra (one tile, the mixed program): the
    class steps replay CUDA graphs on the card and the TUs equal the
    CPU's, whose steps run eagerly. Per frame the program makes as many
    calls into quant_stage_j on the card as on the CPU (the kernel stays
    a host call of its wrapper), every class step is a replay or a
    capture, and the captures are the (class, lane bucket) keys the
    Encoder meets for the first time: the second frame meets keys the
    first did not (its left half is flat: 64x64 leaves, a class the first
    frame lacks). Each call launches the kernel once. A second Encoder in the same process captures its own
    graphs into buffers of its own and codes the same TUs."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=848, h=480, frames=2, seed=3)
    y, u, v = frames[1]
    y = y.copy()
    y[:, :424] = 128
    frames[1] = (y, u, v)
    (cpu_tus, cpu_frames, _), = _graphed_intra(frames, "cpu")
    runs = _graphed_intra(frames, "cuda", encoders=2)
    seen_before = set()
    for f, want in zip(runs[0][1], cpu_frames):
        st = f["stats"]
        assert f["quant_calls"] == want["quant_calls"] > 0
        assert f["launches"] == f["quant_calls"] and want["launches"] == 0
        assert f["keys"] == want["keys"]
        assert st["graph_replays"] + st["graph_captures"] == \
            st["class_steps"] == want["stats"]["class_steps"]
        assert st["graph_captures"] == len(f["keys"] - seen_before)
        assert want["stats"]["graph_replays"] == \
            want["stats"]["graph_captures"] == 0
        seen_before |= f["keys"]
    first, second = runs[0][1]
    assert second["stats"]["graph_captures"] > 0
    assert second["stats"]["graph_replays"] > 0
    assert runs[1][1][0]["stats"] == first["stats"]
    for tus, _, _ in runs:
        assert tus == cpu_tus
    bufs = [{t.data_ptr() for b in enc._class_graphs._planes.values()
             for t in b} for _, _, enc in runs]
    assert bufs[0] and bufs[1] and not bufs[0] & bufs[1]


def test_graphed_class_steps_with_the_tx_search_on_card_equal_cpu(cuda):
    """2 frames of preset-5 all-intra at 448x128 on 4 tile columns with
    the luma tx-type search on: the search inside the class step (its
    tables cached before a capture) replays as graphs and the stream
    equals the CPU's."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=2, seed=3)
    stats, orig = [], tdt._run_program

    def spy(enc, *a):
        out = orig(enc, *a)
        stats.append(enc.fused_stats)
        return out

    tdt._run_program = spy
    try:
        ivf = {d: encode_ivf(frames, dataclasses.replace(preset_config(
            width=448, height=128, preset=5, intra_period=0, tile_columns=2,
            device=d), enable_tx_type_search=True)) for d in ("cuda", "cpu")}
    finally:
        tdt._run_program = orig
    assert ivf["cuda"] == ivf["cpu"]
    card = stats[:2]
    assert all(st["graph_replays"] + st["graph_captures"]
               == st["class_steps"] > 0 for st in card)
    assert sum(st["graph_replays"] for st in card) > 0


def test_capture_outlasts_a_collection_of_another_encoders_graphs(cuda):
    """A garbage cycle holding one Encoder's class-step graphs, made as
    a second Encoder begins a capture, with the collector set to collect
    the youngest objects at every allocation: no collection runs inside
    the capture (CUDA
    forbids destroying a graph on a capturing thread), so it completes
    and the second Encoder's TUs equal the first's."""
    import gc
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import step_graphs
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=1, seed=3)
    cfg = preset_config(width=448, height=128, preset=5, intra_period=0,
                        tile_columns=2, device="cuda")

    def encode(enc):
        tus = []
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
        while (pkt := enc.get_packet()) is not None:
            tus.append(pkt[0])
        return tus

    first = Encoder(cfg)
    want = encode(first)
    garbage = [first._class_graphs]
    first._class_graphs = None
    assert garbage[0].graph_captures
    begin = step_graphs._Capture.begin

    def begin_beside_garbage(self):
        if garbage:
            box = [garbage.pop()]
            box.append(box)
        begin(self)

    second = Encoder(cfg)
    threshold = gc.get_threshold()
    step_graphs._Capture.begin = begin_beside_garbage
    gc.set_threshold(1, 1000, 1000)     # the youngest generation: always
    try:
        got = encode(second)
    finally:
        gc.set_threshold(*threshold)
        step_graphs._Capture.begin = begin
    assert not garbage and second._class_graphs.graph_captures
    assert got == want


def test_tracer_counts_three_item_calls_as_three_syncs(cuda):
    """The tracer's synchronisation counter on the card: three ``.item()``
    calls inside one span count 3 on it, one outside any span counts
    nowhere, and turning the tracer off restores the sync debug mode."""
    from svt_av1_tpu_torch.utils.trace import Tracer
    x = torch.arange(3, device=cuda)
    mode = torch.cuda.get_sync_debug_mode()
    tr = Tracer()
    tr.enabled = True
    try:
        with tr.span("items"):
            got = [x[i].item() for i in range(3)]
        x[0].item()
    finally:
        tr.enabled = False
    assert got == [0, 1, 2]
    assert [(s["stage"], s["syncs"]) for s in tr.spans] == [("items", 3)]
    assert torch.cuda.get_sync_debug_mode() == mode


def test_all_intra_fused_encode_on_card_equals_cpu(cuda):
    """2 frames of all-intra at 448x128 with 4 tile columns: each key
    frame through the frame program on the card, never the per-wave
    loop; the stream equals the CPU's."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.pipeline import wavefront as twf
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=2, seed=3)
    calls = []
    spied = [(tdt, "run_tiles_fused"),
             (twf.WavefrontIntraEncoder, "_code_wave")]
    saved = [getattr(o, n) for o, n in spied]

    def spy(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call

    for (o, n), fn in zip(spied, saved):
        setattr(o, n, spy(n, fn))
    try:
        ivf = {d: encode_ivf(frames, preset_config(
            width=448, height=128, preset=5, intra_period=0,
            tile_columns=2, device=d)) for d in ("cuda", "cpu")}
    finally:
        for (o, n), fn in zip(spied, saved):
            setattr(o, n, fn)
    assert calls == ["run_tiles_fused"] * 4
    assert ivf["cuda"] == ivf["cpu"]


def test_encode_on_card_equals_cpu(cuda):
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=200, h=120, frames=2, seed=3)
    ivf = {d: encode_ivf(frames, preset_config(width=200, height=120,
                                               preset=5, intra_period=0,
                                               device=d))
           for d in ("cuda", "cpu")}
    assert ivf["cuda"] == ivf["cpu"]


@pytest.mark.parametrize("n", [256, 64])
def test_quant_stage_kernel_at_the_inter_batch(cuda, n):
    """The inter path's largest batches: B = 16320 rows, the single-ref
    pair (2B) of 8160 16x16 luma blocks (n = 256) and of their 8x8
    chroma blocks, U+V (n = 64). Exact in every mode and plane type."""
    coeff, qv, lam, scan, tx = stage_rows(n, 0, 16320, 5 * n)
    c, q, lm = (torch.as_tensor(a, device=cuda) for a in (coeff, qv, lam))
    for g, w in zip(dev.quantize_qv(c, scan, q, 0, 8),
                    dev.quantize_qv_plain(c, scan, q, 0, 8)):
        assert torch.equal(g, w)
    for plane_type in (0, 1):
        for rl in (None, lm):
            got = tmd.quant_stage_j(c, scan, q, 0, 8, tx, plane_type, rl)
            want = tmd.quant_stage_plain(c, scan, q, 0, 8, tx, plane_type,
                                         rl)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_pending_qc_resolves_a_cuda_tensor(cuda):
    from svt_av1_tpu_torch.pipeline import common
    qc = (torch.arange(3 * 8 * 8, device=cuda, dtype=torch.int16)
          .reshape(3, 8, 8) - 100)
    pend = common.PendingQC(qc)
    for lane in (2, 0):
        got = common.resolve_qc((pend, lane))
        assert got.dtype == np.int32
        assert np.array_equal(got, qc[lane].cpu().numpy())


def _inter_inputs(device):
    """A frame's source pyramid and chroma, three references prepared by
    ref_prep_dev, on ``device`` (from a seeded clip)."""
    from svt_av1_tpu_torch.ops import device_inter as tdi
    from svt_av1_tpu_torch.pipeline import common
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=192, h=128, frames=4, seed=6)

    def up(planes):
        return [torch.as_tensor(p.astype(np.uint8), device=device)
                for p in common.pad_frame_planes(*planes, dtype=np.int32)]

    refs = [tdi.ref_prep_dev(up(frames[i])) for i in (0, 3, 2)]
    src = up(frames[1])
    return src, tdi.src_pyramid_dev(src[0]), refs


def test_inter_programs_on_card_equal_cpu(cuda):
    """The shape group (with compound), the partition DP's device work
    and the flip decision on cuda equal the same functions on the CPU,
    integer for integer."""
    from svt_av1_tpu_torch.ops import device_inter as tdi
    from svt_av1_tpu_torch.pipeline import rd
    qp = quant_ops.make_quant_params(100)
    lam = rd.rd_lambda(100, 8)
    res = {}
    for d in ("cuda", "cpu"):
        src, spyr, refs = _inter_inputs(d)
        gx, gy = np.meshgrid(np.arange(0, 192, 16), np.arange(0, 128, 16))
        xs, ys = gx.reshape(-1), gy.reshape(-1)
        recon = [torch.zeros_like(p) for p in src]
        _, outs, _ = tdi.shape_group_issue(
            recon, [r[1] for r in refs], [r[0][1] for r in refs],
            [r[0][2] for r in refs], spyr, src[1], src[2], xs, ys, 16, qp,
            lam, (0, 1), (2,), bd=8, rdoq=True)
        dp = tdi.dp_all_dev(refs[0][1], spyr, 192, 128, (64, 32, 16, 8),
                            [(32, (32, 16), ((0, 0), (0, 16)))])
        b = len(xs)
        fd, _ = tdi.flip_decision_issue(
            src[0], recon[0], xs, ys, ys > 0, xs > 0, np.ones(b, bool),
            np.zeros(b, bool), (0, 1, 2, 12), 16, qp, lam,
            np.full(b, 192), np.full(b, 128), bd=8, rdoq=True)
        res[d] = ([o.cpu() for o in outs] + [p.cpu() for p in recon]
                  + [o.cpu() for o in fd], dp)
    for g, w in zip(res["cuda"][0], res["cpu"][0]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert res["cuda"][1].keys() == res["cpu"][1].keys()
    for k in res["cpu"][1]:
        for g, w in zip(res["cuda"][1][k], res["cpu"][1][k]):
            assert np.array_equal(g, w)


def test_flip_apply_on_card_equals_cpu(cuda):
    """flip_apply_fused's dependency-wave loop on cuda equals the CPU:
    recon planes, coefficients, eobs and CfL choices."""
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.pipeline import common
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.pipeline.inter import InterFrameEncoder
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=192, h=128, frames=2, seed=8)
    res = {}
    for d in ("cuda", "cpu"):
        cfg = EncoderConfig(width=192, height=128, intra_period=-1,
                            intra_modes=(0, 1, 2, 12), tile_cols_log2=1,
                            fixed_partition_size=16, device=d)
        enc = InterFrameEncoder(cfg, Encoder(cfg).seq)
        enc.leaf_sizes = common.fixed_leaf_sizes(
            enc.mi_rows, enc.mi_cols, enc.seq.sb_rows, enc.seq.sb_cols, 16)
        order = common.leaves_in_coding_order(
            enc.leaf_sizes, enc.mi_rows, enc.mi_cols, enc.seq.sb_rows,
            enc.seq.sb_cols)
        n = len(order)
        enc.qmap = None
        enc.src = [torch.as_tensor(p.astype(np.uint8), device=d) for p in
                   common.pad_frame_planes(*frames[1], dtype=np.int32)]
        enc.recon = [torch.as_tensor(p.astype(np.uint8), device=d) for p in
                     common.pad_frame_planes(*frames[0], dtype=np.int32)]
        enc.qcoeff = [[None] * n for _ in range(3)]
        enc.eobs = np.zeros((3, n), np.int32)
        enc.block_is_inter = np.ones(n, bool)
        enc.intra_mode = np.zeros(n, np.int32)
        enc.intra_uv_cfl = np.zeros(n, bool)
        enc.intra_alpha_u = np.zeros(n, np.int64)
        enc.intra_alpha_v = np.zeros(n, np.int64)
        flips = [(r, c, s, i, (0, 1, 2, 12)[i % 4])
                 for i, (r, c, s) in enumerate(order) if i % 3]
        tdt.flip_apply_fused(enc, enc._flip_waves(flips))
        qcs = [common.resolve_qc(enc.qcoeff[p][i]) for p in range(3)
               for i in range(n) if enc.qcoeff[p][i] is not None]
        res[d] = ([p.cpu() for p in enc.recon], qcs, enc.eobs.copy(),
                  enc.intra_uv_cfl.copy(), enc.intra_alpha_u.copy(),
                  enc.intra_alpha_v.copy())
    for g, w in zip(res["cuda"][0], res["cpu"][0]):
        assert torch.equal(g, w)
    assert len(res["cuda"][1]) == len(res["cpu"][1]) > 0
    for g, w in zip(res["cuda"][1], res["cpu"][1]):
        assert np.array_equal(g, w)
    for g, w in zip(res["cuda"][2:], res["cpu"][2:]):
        assert np.array_equal(g, w)


def test_inter_encode_on_card_equals_cpu(cuda):
    """A random-access stream (hier-3, 4 tile columns, partition DP) on
    the card equals the same encoder on the CPU."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=9, seed=3)
    ivf = {d: encode_ivf(frames, preset_config(
        width=448, height=128, preset=5, intra_period=-1,
        hierarchical_levels=3, tile_columns=2, device=d))
        for d in ("cuda", "cpu")}
    assert ivf["cuda"] == ivf["cpu"]


def _streams(frames, **options):
    """encode_ivf of ``frames`` on cuda and on the CPU, with the per-wave
    loop's calls on each device counted."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline import wavefront as twf
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    h, w = frames[0][0].shape
    orig = twf.WavefrontIntraEncoder._code_wave
    ivf, waves = {}, {}
    for d in ("cuda", "cpu"):
        n = []

        def spy(self, *a, **k):
            n.append(self._edge)
            return orig(self, *a, **k)

        twf.WavefrontIntraEncoder._code_wave = spy
        try:
            ivf[d] = encode_ivf(frames, preset_config(
                width=w, height=h, device=d, **options))
        finally:
            twf.WavefrontIntraEncoder._code_wave = orig
        waves[d] = n
    return ivf, waves


def test_directional_all_intra_on_card_equals_cpu(cuda):
    """Preset 2 (the CLI default) all-intra at 448x128 with 4 tile
    columns: every key frame through the per-wave loop with the intra
    edge filter, on the card as on the CPU, byte for byte."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=2, seed=3)
    ivf, waves = _streams(frames, preset=2, intra_period=0, tile_columns=2)
    assert waves["cuda"] and all(waves["cuda"])
    assert len(waves["cuda"]) == len(waves["cpu"])
    assert ivf["cuda"] == ivf["cpu"]


def test_directional_ra_on_card_equals_cpu(cuda):
    """Preset 2 random access, hier-3, 9 frames at 448x128: the inter
    frames' rect shape groups and intra flips on the card."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=9, seed=3)
    ivf, waves = _streams(frames, preset=2, intra_period=-1,
                          hierarchical_levels=3, tile_columns=2)
    assert waves["cuda"] and all(waves["cuda"])
    assert ivf["cuda"] == ivf["cpu"]


def test_preset3_rect_classes_on_card_equal_cpu(cuda):
    """Preset 3 all-intra at 448x128: the fused frame program with rect
    leaf classes (row lengths 32, 128, 512 in the kernel)."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=1, seed=3)
    before = collections.Counter(dev.LAUNCH_SHAPES)
    ivf, waves = _streams(frames, preset=3, intra_period=0, tile_columns=2)
    ns = {k[2] for k in collections.Counter(dev.LAUNCH_SHAPES) - before}
    assert ns & {32, 128, 512}, ns
    assert not waves["cuda"]
    assert ivf["cuda"] == ivf["cpu"]


def test_10bit_all_intra_on_card_equals_cpu(cuda):
    """A 10-bit preset-5 all-intra stream (the frame program and DLF at
    10 bits) on the card equals the CPU's."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = [tuple(p.astype(np.uint16) << 2 for p in f)
              for f in make_clip(w=448, h=128, frames=2, seed=3)]
    ivf, _ = _streams(frames, preset=5, intra_period=0, bit_depth=10,
                      tile_columns=2)
    assert ivf["cuda"] == ivf["cpu"]


def _postfilter_planes(bd, seed, h=1080, w=1920):
    """Padded recon and source planes of a 1080p frame: the source mixes
    a smooth field with hard edges, the recon adds noise, light on the
    left half and strong on the right (so the filters engage); SB (0, 0)
    is flat in both (all four CDEF presets tie there)."""
    rng = np.random.default_rng(seed)
    peak = (1 << bd) - 1
    dt = np.uint8 if bd <= 8 else np.uint16
    Hp, Wp = -(-h // 64) * 64, -(-w // 64) * 64
    recon, src = [], []
    for p in range(3):
        ss = 1 if p else 0
        yy, xx = np.mgrid[0:Hp >> ss, 0:Wp >> ss]
        clean = peak / 2 + (peak / 4) * np.sin(xx / 13.0) \
            * np.cos(yy / 17.0) + (peak / 8) * np.sign(
                np.sin(xx / (5.0 - 2 * ss) + yy / (9.0 - 3 * ss)))
        clean[:64 >> ss, :64 >> ss] = peak // 3
        s = np.clip(clean, 0, peak).astype(np.int32)
        lvl = np.where(xx < (Wp >> ss) // 2, 1.5, 12.0) * (peak + 1) / 256
        r = np.clip(s + rng.normal(0, 1, s.shape) * lvl, 0, peak)
        r[:64 >> ss, :64 >> ss] = peak // 3
        src.append(s)
        recon.append(r.astype(dt))
    return recon, src


@pytest.mark.parametrize("bd", [8, 10])
def test_cdef_at_1080p_on_card_equals_cpu(cuda, bd):
    """CDEF's search + apply on 1920x1080 planes (the fp64 direction
    projection, int64 SSEs, the 1080p SB padding: h8 = 135 of 17 SB
    rows): tensors on the card filtered in place equal numpy planes on
    the CPU, index map and all."""
    from svt_av1_tpu_torch.ops import device_cdef as tdc
    recon, src = _postfilter_planes(bd, 20 + bd)
    mi_rows, mi_cols = 270, 480
    skip8 = np.random.default_rng(bd).random((135, 240)) < 0.25
    qindex = 120
    cpu = [p.copy() for p in recon]
    want = tdc.cdef_search_apply_dev(cpu, src, skip8, mi_rows, mi_cols,
                                     qindex, bd, device="cpu")
    rec = [torch.as_tensor(p, device=cuda) for p in recon]
    got = tdc.cdef_search_apply_dev(
        rec, [torch.as_tensor(p, device=cuda) for p in src], skip8, mi_rows,
        mi_cols, qindex, bd, device="cuda")
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert want[0][0, 0] == 0 and (want[0] > 0).any()   # tie; engages
    for a, b in zip(rec, cpu):
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.parametrize("bd", [8, 10])
def test_lr_at_1080p_on_card_equals_cpu(cuda, bd):
    """Loop restoration on 1920x1080 planes: pass A's integer statistics
    (the fp64 Gram products, where a TF32 or overflow fault would show),
    the per-unit choices and the filtered planes on the card equal the
    CPU's."""
    from svt_av1_tpu_torch.ops import device_lr as tdl
    from svt_av1_tpu_torch.ops import restoration as rst
    from svt_av1_tpu_torch.pipeline import lr_search as tlr
    from svt_av1_tpu_torch.pipeline.rd import rd_lambda
    w, h, qindex = 1920, 1080, 120
    recon, src = _postfilter_planes(bd, 30 + bd)
    bounds = [tdl.deblock_bounds_dev(recon[p], (h + (p > 0)) >> (p > 0),
                                     (w + (p > 0)) >> (p > 0), int(p > 0))
              for p in range(3)]
    rec = [torch.as_tensor(p, device=cuda) for p in recon]
    srcs = [torch.as_tensor(p, device=cuda) for p in src]
    for a, b in zip(tdl.lr_stats_dev(tdl.lr_planes(rec, srcs, bounds, w, h,
                                                   bd, device="cuda")),
                    tdl.lr_stats_dev(tdl.lr_planes(recon, src, bounds, w, h,
                                                   bd, device="cpu"))):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    lam = rd_lambda(qindex, bd)
    cpu = [p.copy() for p in recon]
    want = tlr.search_restoration_dev(cpu, src, bounds, w, h, bd, qindex,
                                      lam, device="cpu")
    got = tlr.search_restoration_dev(rec, srcs, bounds, w, h, bd, qindex,
                                     lam, device="cuda")
    for g, r in zip(got, want):
        assert g.frame_restoration_type == r.frame_restoration_type
        assert [vars(u) for u in g.units] == [vars(u) for u in r.units]
    assert any(r.frame_restoration_type != rst.RESTORE_NONE for r in want)
    for a, b in zip(rec, cpu):
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.parametrize("preset", [0, 1])
def test_postfilter_presets_all_intra_on_card_equal_cpu(cuda, preset):
    """Presets 0 and 1 all-intra at 448x128 with 4 tile columns: CDEF
    (and LR at preset 0) after the per-wave loop, on the card as on the
    CPU, byte for byte."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=128, frames=1, seed=3)
    ivf, waves = _streams(frames, preset=preset, intra_period=0,
                          tile_columns=2)
    assert waves["cuda"] and all(waves["cuda"])
    assert ivf["cuda"] == ivf["cpu"]


def test_postfilter_ra_on_card_equals_cpu(cuda):
    """Random access hier-3, 9 frames at 448x128, 4 tile columns, preset
    5 with CDEF and LR on: both filters on every frame's recon on the
    card (the reference slots keep the filtered planes), byte for byte
    the CPU's stream."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.clip import make_clip
    from svt_av1_tpu_torch.utils.trace import TRACER
    frames = make_clip(w=448, h=128, frames=9, seed=3)
    ivf, counts = {}, {}
    for d in ("cuda", "cpu"):
        cfg = dataclasses.replace(preset_config(
            width=448, height=128, preset=5, intra_period=-1,
            hierarchical_levels=3, tile_columns=2, device=d),
            enable_cdef=True, enable_restoration=True)
        TRACER.enabled = True
        TRACER.reset()
        try:
            ivf[d] = encode_ivf(frames, cfg)
        finally:
            TRACER.enabled = False
        spans = TRACER.summary()
        counts[d] = (spans["cdef"]["count"], spans["lr"]["count"])
    assert counts == {"cuda": (9, 9), "cpu": (9, 9)}
    assert ivf["cuda"] == ivf["cpu"]


@pytest.mark.parametrize("preset", [0, 1])
def test_search_presets_ra_on_card_equal_cpu(cuda, preset):
    """Presets 0 and 1 random access hier-3, 9 frames at 448x128 with 4
    tile columns: the non-fused inter path (the interpolation-filter
    search, and at preset 0 the inter tx-type sweep) on every inter frame,
    on the card as on the CPU, byte for byte."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    from svt_av1_tpu_torch.utils.trace import TRACER
    frames = make_clip(w=448, h=128, frames=9, seed=3)
    TRACER.enabled = True
    TRACER.reset()
    try:
        ivf, waves = _streams(frames, preset=preset, intra_period=-1,
                              hierarchical_levels=3, tile_columns=2)
    finally:
        TRACER.enabled = False
    spans = TRACER.summary()
    frames_of = collections.Counter(s["stage"] for s in TRACER.spans)
    assert frames_of["inter_frame"] == 16                 # 8 per device
    assert spans["interp_filter_search"]["count"] >= 16
    assert ("inter_tx_search" in spans) == (preset == 0)
    assert ivf["cuda"] == ivf["cpu"]


def test_per_lane_filter_mc_at_the_inter_batch(cuda):
    """Per-lane filter-type MC (single-ref and the compound CONV side) at
    a 1080p shape group's batch: 8160 16x16 luma blocks and their 8x8
    chroma, and 4x4 chroma (the 4-tap banks), over a stacked bank of
    three 1080p references, on the card as on the CPU."""
    from svt_av1_tpu_torch.ops import device_inter as di
    from svt_av1_tpu_torch.ops import mc
    rng = np.random.default_rng(17)
    for (w, h, ss, plane_hw) in ((16, 16, 0, (1080, 1920)),
                                 (8, 8, 1, (540, 960)),
                                 (4, 4, 1, (540, 960))):
        ph, pw = plane_hw
        b = (ph // h) * (pw // w) if ss == 0 else 8160
        bank = np.stack([mc.pad_reference(
            rng.integers(0, 256, plane_hw).astype(np.uint8))
            for _ in range(3)])
        xs = rng.integers(0, pw - w + 1, b)
        ys = rng.integers(0, ph - h + 1, b)
        mvs = np.array([mc.clamp_mv_for_padding(m, x, y, w, h, pw, ph, ss)
                        for m, x, y in zip(rng.integers(-300, 300, (b, 2)),
                                           xs, ys)], np.int64)
        ops = [torch.as_tensor(a) for a in
               (bank, xs, ys, mvs, rng.integers(0, 3, b),
                rng.integers(0, 3, b))]
        for fn in (dev.mc_block_batch_j, di.mc_block_batch_conv_j):
            got = fn(*[o.to(cuda) for o in ops[:4]], w, h, ss=ss,
                     ref_idx=ops[4].to(cuda), ftype=ops[5].to(cuda))
            want = fn(*ops[:4], w, h, ss=ss, ref_idx=ops[4],
                      ftype=ops[5])
            assert torch.equal(got.cpu(), want)


def _tool_streams(frames, **extra):
    """encode_ivf of ``frames`` at preset 5, hier-3, 2 tile columns, with
    the rate and analysis tools in ``extra``, on cuda and on the CPU."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    h, w = frames[0][0].shape
    return {d: encode_ivf(frames, dataclasses.replace(preset_config(
        width=w, height=h, preset=5, intra_period=-1, hierarchical_levels=3,
        tile_columns=1, device=d), **extra)) for d in ("cuda", "cpu")}


def test_aq_stream_on_card_equals_cpu(cuda):
    """Variance AQ at 448x136 (a partial superblock row): the key frame's
    per-wave loop and the inter shape groups and flips with per-lane
    qindex, on the card as on the CPU."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=136, frames=9, seed=3)
    ivf = _tool_streams(frames, adaptive_quantization=1)
    assert ivf["cuda"] == ivf["cpu"]


def test_vbr_tpl_stream_on_card_equals_cpu(cuda):
    """VBR with lookahead, TPL AQ, film grain and denoising: the rate
    controller reads every frame's bits before the next frame's qindex,
    so the card's stream equals the CPU's."""
    from svt_av1_tpu_torch.config import RateControlMode
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=136, frames=9, seed=3)
    ivf = _tool_streams(frames, adaptive_quantization=2,
                        rate_control_mode=RateControlMode.VBR,
                        target_bit_rate=600_000, look_ahead_distance=4,
                        film_grain_strength=10, enable_source_denoise=True)
    assert ivf["cuda"] == ivf["cpu"]


def test_satd_dp_stream_on_card_equals_cpu(cuda):
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=448, h=136, frames=5, seed=3)
    ivf = _tool_streams(frames, intra_dp_satd=True)
    assert ivf["cuda"] == ivf["cpu"]


@pytest.mark.parametrize("bd", [8, 10])
def test_satd_modes_on_card_equal_cpu(cuda, bd):
    """The SATD twin (float64 Hadamard products) on the card against its
    CPU run at every DP size, with saturated residuals, at a 1080p
    depth's batch (8160 16x16 blocks)."""
    from svt_av1_tpu_torch.pipeline import rd
    rng = np.random.default_rng(bd)
    src = rng.integers(0, 1 << bd, (1088, 1920)).astype(np.int32)
    src[:, ::2] = (1 << bd) - 1
    for size in (8, 16, 32, 64, (16, 8), (8, 16), (32, 16), (16, 32),
                 (64, 32), (32, 64), (32, 8), (8, 32), (64, 16), (16, 64)):
        bw, bh = (size, size) if isinstance(size, int) else size
        gy, gx = np.mgrid[0:1088 - bh + 1:bh, 0:1920 - bw + 1:bw]
        xs, ys = gx.reshape(-1), gy.reshape(-1)
        ins = rd._depth_inputs(src, xs, ys, size, 1920, 1080, 480, 270, bd)
        modes = (0, 1, 2, 3, 7, 9, 12)
        got = tmd.satd_modes(*ins, modes, size, bd, device="cuda")
        want = tmd.satd_modes(*ins, modes, size, bd, device="cpu")
        assert torch.equal(got.cpu(), want), size


def test_checkpoint_moves_between_card_and_cpu(cuda):
    """A checkpoint taken on the card resumes on the CPU, and one taken
    on the CPU on the card; both streams equal the uninterrupted one."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=192, h=128, frames=11, seed=4)

    def packets(enc, send):
        out = []
        for f in send:
            enc.send_picture(*f)
            while (p := enc.get_packet()) is not None:
                out.append(p[0])
        return out

    def finish(enc):
        enc.flush()
        out = []
        while (p := enc.get_packet()) is not None:
            out.append(p[0])
        return out

    cfgs = {d: preset_config(width=192, height=128, preset=5,
                             hierarchical_levels=2, tbr=400_000, lad=3,
                             device=d) for d in ("cuda", "cpu")}
    whole = Encoder(cfgs["cpu"])
    want = packets(whole, frames) + finish(whole)
    for first, then in (("cuda", "cpu"), ("cpu", "cuda")):
        enc = Encoder(cfgs[first])
        got = packets(enc, frames[:6])
        state = enc.save_state()
        got += packets(enc, [])
        resumed = Encoder.load_state(state, device=then)
        assert resumed.cfg.device == then
        got += packets(resumed, frames[6:]) + finish(resumed)
        assert got == want, (first, then)


@pytest.fixture
def cold_build(tmp_path, monkeypatch):
    """Empty kernel and native-coder build directories for one test: the
    libraries build again at first use, and the loaded ones are dropped
    before and after."""
    from svt_av1_tpu_torch import cuda_build, native
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build" / "cuda")
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build" / "native")
    dev._quant_lib.cache_clear()
    native.lib.cache_clear()
    yield tmp_path / "build"
    dev._quant_lib.cache_clear()
    native.lib.cache_clear()


@pytest.mark.parametrize("parallel", [["--jobs", "2", "--intra-period", "1",
                                       "--preset", "7"],
                                      ["--nch", "2", "--preset", "5"]],
                         ids=["jobs2", "nch2"])
def test_cli_threads_on_card_from_a_cold_build_equal_cpu(cuda, cold_build,
                                                         tmp_path,
                                                         parallel):
    """The encoder CLI on the card with two encoder threads (parallel
    GOPs, or two channels) that reach the kernel's first use together on
    an empty build directory: one library is built, the kernel runs, and
    the streams equal the CPU's."""
    from svt_av1_tpu_torch.app import cli
    from svt_av1_tpu_torch.utils.clip import make_clip, write_y4m
    ins = [tmp_path / "a.y4m", tmp_path / "b.y4m"]
    for i, path in enumerate(ins):
        write_y4m(path, make_clip(w=448, h=128, frames=4, seed=3 + i))
    n = 2 if "--nch" in parallel else 1
    out = {}
    for device in ("cuda", "cpu"):
        outs = [tmp_path / f"{device}{i}.ivf" for i in range(n)]
        before = sum(dev.LAUNCHES.values())
        assert cli.main(["-i", ",".join(map(str, ins[:n])), "-b",
                         ",".join(map(str, outs)), "--no-stats",
                         "--device", device, *parallel]) == 0
        if device == "cuda":
            assert sum(dev.LAUNCHES.values()) > before
        out[device] = [p.read_bytes() for p in outs]
    assert out["cuda"] == out["cpu"]
    built = sorted(p.name for p in (cold_build / "cuda").iterdir())
    assert len(built) == 2 and built[0] == ".lock", built
    assert built[1].startswith("libquant.") and built[1].endswith(".so")


def test_entry_steps_on_card_equal_cpu(cuda):
    """entry() and the three analysis steps on the card equal their CPU
    runs; each launches the kernel's quantize-only mode and never its
    plain version."""
    from svt_av1_tpu_torch.entry import entry
    from svt_av1_tpu_torch.ops import mc as mch
    plain = []
    real_plain = dev.quantize_qv_plain

    def spy(*a, **k):
        plain.append(1)
        return real_plain(*a, **k)

    def run(fn, *args, **kw):
        """(card results, CPU results) of ``fn``; checks the launches."""
        before = dev.LAUNCHES["quantize_qv"]
        dev.quantize_qv_plain = spy
        try:
            got = fn(*(torch.as_tensor(a, device=cuda) for a in args), **kw)
            torch.cuda.synchronize()
        finally:
            dev.quantize_qv_plain = real_plain
        assert dev.LAUNCHES["quantize_qv"] > before and not plain
        want = fn(*(torch.as_tensor(a) for a in args), **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)

    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    run(fn, *(a.cpu() for a in args))
    rng = np.random.default_rng(5)
    for size, qindex, bd in ((16, 160, 8), (32, 0, 10), (64, 255, 8)):
        b, hi = 40, 1 << bd
        ins = (rng.integers(0, hi, (b, size, size)),
               rng.integers(0, hi, (b, 2 * size)),
               rng.integers(0, hi, (b, 2 * size)), rng.integers(0, hi, b),
               rng.integers(0, 2, b).astype(bool),
               rng.integers(0, 2, b).astype(bool))
        run(dev.intra_analysis_step,
            *(a.astype(np.int32) if a.dtype != bool else a for a in ins),
            size=size, qindex=qindex, bd=bd)
    cur, ref = _luma_pair(448, 128)
    run(dev.inter_core_step, cur, np.pad(ref, 16, mode="edge"), size=16,
        search_range=16)
    run(dev.inter_core_subpel_step, cur,
        mch.pad_reference(ref).astype(np.int32), size=16, search_range=16)


def _luma_pair(w, h):
    """Luma of frames 1 and 0 of the synthetic clip, int32."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    f0, f1 = make_clip(w=w, h=h, frames=2, seed=3)
    return f1[0].astype(np.int32), f0[0].astype(np.int32)



def _mc_clip(w, h, n, seed=9):
    """tests/test_multichip.py's clip (seeded numpy)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h + 64, w + 64)).astype(np.uint8)
    return [(base[2 * t:2 * t + h, 3 * t:3 * t + w],
             np.full((h // 2, w // 2), 100 + 5 * t, np.uint8),
             rng.integers(100, 160, (h // 2, w // 2)).astype(np.uint8))
            for t in range(n)]


def test_tile_sharded_keyframe_4_on_card_equals_cpu(cuda):
    """4 tiles on ["cuda:0"] * 4 (512x128): the TU, halo_ok and stats
    equal the same function on ["cpu"] * 4, and the fused kernel launched
    inside every tile program."""
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.parallel import tiles
    (y, u, v), = _mc_clip(512, 128, 1)
    out, reports = {}, {}
    for d in ("cuda:0", "cpu"):
        cfg = EncoderConfig(width=512, height=128, qp=40, tile_cols_log2=2,
                            fixed_partition_size=16,
                            enable_intra_edge_filter=False, device=d)
        reports[d] = {}
        out[d] = tiles.encode_keyframe_tiles_sharded(
            y, u, v, cfg, [d] * 4, report=reports[d])
        assert reports[d]["injected"] == 4
    assert out["cuda:0"] == out["cpu"] and out["cpu"][1]
    for t in reports["cuda:0"]["tiles"]:
        assert t["launches"].get("quant_stage_rdoq", 0) > 0, t


@pytest.mark.parametrize("bd", [8, 10])
def test_sharded_dlf_4_on_card_equals_host(cuda, bd):
    """The distributed DLF over 4 strips of cuda:0 (512x64) equals the
    port's host filter, as on the CPU."""
    from svt_av1_tpu_torch.ops import dlf
    from svt_av1_tpu_torch.parallel import tiles
    rng = np.random.default_rng(bd)
    w, h = 512, 64
    src = [rng.integers(0, 1 << bd, s).astype(np.uint16)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    rec = [(p // 16 * 16).astype(np.uint16) for p in src]
    leaf_sizes = {(r, c): 16 for r in range(0, h // 4, 4)
                  for c in range(0, w // 4, 4)}
    want_lv = dlf.pick_levels(rec, [p.astype(np.int64) for p in src],
                              leaf_sizes, h // 4, w // 4, 180, bd)
    want = [p.copy() for p in rec]
    dlf.loop_filter_frame(want, leaf_sizes, h // 4, w // 4, want_lv, bd=bd)
    planes, levels = tiles.dlf_search_apply_sharded(
        rec, src, leaf_sizes, h // 4, w // 4, 180, bd, ["cuda:0"] * 4)
    assert levels == want_lv
    for a, b in zip(planes, want):
        assert np.array_equal(a, b)


def test_strip_sharded_inter_on_card_equals_cpu(cuda):
    """Low-delay P (512x64) with every shape group over 4 strips of
    cuda:0 equals the unsharded stream on the CPU: the sharded functions
    refuse nothing on the card that they take on the CPU."""
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.parallel import tiles
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    frames = _mc_clip(512, 64, 3)

    def cfg(d):
        return EncoderConfig(width=512, height=64, qp=40,
                             hierarchical_levels=0, fixed_partition_size=16,
                             device=d)

    sharded = encode_ivf(frames, cfg("cuda:0"),
                         shape_group_issue=tiles.make_sharded_shape_group_issue(
                             ["cuda:0"] * 4, strip_w=128))
    assert sharded == encode_ivf(frames, cfg("cpu"))


# the JAX package's streams of chip_smoke.BASELINE's operating points cut
# to their first 2 frames (tests/torch_baseline_goldens.py --frames 2;
# hires4k and ai480 are 2 frames long already)
BASELINE_2 = {
    "hires4k": (1560782, "6f9db4d99a16e0386385c47208491cbc7fe7c9caf5c5d5dfd"
                         "152752b3097575c"),
    "vbr10": (12602, "36d579c5d9f76273a76cf6fc1a5984036afff175fd48caffd5d7a"
                     "08a885139cd"),
    "ai480": (153374, "2c367518db7d1176acf55f1fccda7c556936cca47336a5ae0a3e"
                      "24eecc762965"),
    "ldp720": (175681, "87628262071552d8e66b331485c0dbb20ca8c908663fefcfdd0"
                       "90af9f4ebb567"),
}


@pytest.mark.parametrize("name", sorted(BASELINE_2))
def test_baseline_point_on_card_equals_the_jax_golden(cuda, name,
                                                      monkeypatch):
    """chip_smoke's [baseline] checks at 2-frame depth: the stream equals
    the JAX package's, the fused kernel runs and the plain trim and rate
    never, and every key frame runs a fused program (the frame program
    over all tiles, or the one-tile program) and never the per-wave
    loop."""
    import hashlib

    import chip_smoke
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.pipeline import wavefront as twf
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    point = next(p for p in chip_smoke.BASELINE if p[0] == name)
    _, clip, args, options, tiles = point[:5]
    frames = chip_smoke._baseline_frames(clip, args)[:2]
    calls = []

    def spy(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            calls.append((name, len(a[1]) if name == "run_tiles_fused"
                          else out))
            return out
        return call

    for obj, nm in ((tdt, "run_tiles_fused"), (tdt, "analyze_tile_fused"),
                    (tdt, "analyze_tile_fused_mixed"),
                    (twf.WavefrontIntraEncoder, "_code_wave"),
                    (tmd, "rdoq_trim_j"), (tmd, "_rate_cdf_j")):
        monkeypatch.setattr(obj, nm, spy(nm, getattr(obj, nm)))
    dev.LAUNCHES.clear()
    ivf = encode_ivf(frames, preset_config(**options, device="cuda"))
    assert (len(ivf), hashlib.sha256(ivf).hexdigest()) == BASELINE_2[name]
    assert dev.LAUNCHES["quant_stage_rdoq"] + dev.LAUNCHES["quant_stage"] > 0
    names = [c[0] for c in calls]
    assert not {"_code_wave", "rdoq_trim_j", "_rate_cdf_j"} & set(names)
    keys = 2 if options["intra_period"] == 0 else 1
    if tiles > 1:
        assert calls == [("run_tiles_fused", tiles)] * keys
    else:
        assert "run_tiles_fused" not in names
        assert len([c for c in calls if c[1] is True]) == keys
