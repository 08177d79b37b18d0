"""The 12 seeds of ``tests/test_fuzz_configs.py`` against the port: the
same draw sequence builds each seed's config and frames, the port on the
CPU must give the JAX host stream byte for byte, and the port's own
decoder must reproduce the port's recon. ``tests/test_torch_fuzz_
configs_a.py`` and ``_b.py`` run six seeds each."""

import numpy as np

from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.pipeline.encoder import Encoder as JaxEncoder
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.pipeline.decode import StreamDecoder
from svt_av1_tpu_torch.pipeline.encoder import Encoder


def _content(rng, w, h, bd):
    peak = (1 << bd) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    kind = rng.randint(3)
    if kind == 0:      # noise
        y = rng.randint(0, peak + 1, (h, w))
    elif kind == 1:    # structure + noise
        y = (peak / 2 + (peak / 3) * np.sin(yy / 9.0) * np.cos(xx / 13.0)
             + rng.normal(0, peak / 32, (h, w)))
    else:              # flat gradient
        y = np.tile(np.linspace(0, peak, w), (h, 1))
    dt = np.uint16 if bd > 8 else np.uint8
    y = np.clip(y, 0, peak).astype(dt)
    u = np.clip(rng.randint(0, peak + 1, ((h + 1) // 2, (w + 1) // 2)),
                0, peak).astype(dt)
    v = np.full(((h + 1) // 2, (w + 1) // 2), peak // 2, dt)
    return y, u, v


def fuzz_case(seed):
    """(config options, frames) of ``test_fuzz_configs.py``'s seed."""
    rng = np.random.RandomState(1000 + seed)
    w = int(rng.choice([64, 128, 200, 192]))
    h = int(rng.choice([64, 96, 120, 128]))
    bd = int(rng.choice([8, 8, 10]))
    tiles = int(rng.choice([0, 1])) if w >= 128 else 0
    enable_restoration = bool(rng.randint(2))
    kw = dict(
        width=w, height=h, bit_depth=bd,
        qp=int(rng.randint(15, 60)),
        intra_period=int(rng.choice([-1, 0, 4])),
        hierarchical_levels=int(rng.choice([0, 1, 2])),
        enable_cdef=bool(rng.randint(2)),
        enable_restoration=enable_restoration,
        enable_dlf=bool(rng.randint(2)),
        enable_tx_type_search=bool(rng.randint(2)),
        enable_interp_filter_search=bool(rng.randint(2)),
        adaptive_quantization=int(rng.randint(3)),  # 2 = TPL AQ
        film_grain_strength=int(rng.choice([0, 0, 12])),
        tile_cols_log2=tiles,
        fixed_partition_size=[None, 16, 32][rng.randint(3)],
        nfl=int(rng.randint(1, 4)),
        scene_change_detection=False,
        native_entropy=bool(rng.randint(2)),
    )
    n_frames = 3 if kw["intra_period"] != 0 else 2
    return kw, [_content(rng, w, h, bd) for _ in range(n_frames)]


def _packets(enc, frames) -> list:
    outs = []
    for f in frames:
        enc.send_picture(*f)
        while (p := enc.get_packet()) is not None:
            outs.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        outs.append(p)
    return outs


def check_seed(seed) -> None:
    kw, frames = fuzz_case(seed)
    want = [tu for tu, _ in _packets(JaxEncoder(JaxConfig(**kw)), frames)]
    outs = _packets(Encoder(EncoderConfig(device="cpu", **kw)), frames)
    assert [tu for tu, _ in outs] == want, f"seed {seed} cfg {kw}"
    dec = StreamDecoder()
    shown = 0
    for tu, disp in outs:
        out = dec.decode_tu(tu)
        if disp is None:
            continue
        shown += 1
        for p in range(3):
            assert np.array_equal(out[p], disp[p]), \
                f"seed {seed} frame {shown} plane {p}"
    assert shown == len(frames), (seed, shown, len(frames))
