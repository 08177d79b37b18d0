"""Preset mapping of the encoder CLI (the port keeps only ``preset_config``).

The preset ladder is the JAX package's ``app/cli.py:preset_config``,
unchanged, with the torch ``device`` in the place of its ``backend``.
Every preset encodes all-intra and with inter frames on the device;
presets 0 and 1 with CDEF (and preset 0 with loop restoration) and, in
inter frames, the interpolation-filter search (and preset 0's inter
tx-type search) on the non-fused inter path.
"""

from __future__ import annotations

from svt_av1_tpu_torch.config import EncoderConfig, RateControlMode

# the encoder CLI's option defaults (``-w``/``-h`` have none that encodes)
CLI_DEFAULTS = dict(width=0, height=0, qp=40, bit_depth=8, intra_period=-1,
                    fps=30, film_grain=0, enable_denoise=False, preset=2,
                    hierarchical_levels=0, tbr=0, lad=0, tile_columns=None,
                    tile_rows=None, qp_file=None, device="cuda")


def preset_config(**options) -> EncoderConfig:
    """Map the preset scale onto mode-decision budgets (the analogue of
    the reference's signal_derivation_*_oq feature levels).

    ``options``: the CLI's option names as keywords, over CLI_DEFAULTS,
    e.g. ``preset_config(width=1920, height=1080, preset=5,
    intra_period=0)``."""
    unknown = set(options) - set(CLI_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown options {sorted(unknown)}")
    a = {**CLI_DEFAULTS, **options}
    kw = dict(width=a["width"], height=a["height"], qp=a["qp"],
              bit_depth=a["bit_depth"], intra_period=a["intra_period"],
              frame_rate_num=a["fps"],
              film_grain_strength=a["film_grain"],
              enable_source_denoise=a["enable_denoise"])
    preset = a["preset"]
    if preset <= 0:       # M0: full tools
        kw.update(fixed_partition_size=None, nfl=4,
                  angle_deltas=(-3, -2, -1, 0, 1, 2, 3),
                  enable_cdef=True, enable_restoration=True,
                  enable_tx_type_search=True,
                  enable_interp_filter_search=True)
    elif preset == 1:     # M1
        kw.update(fixed_partition_size=None, nfl=3,
                  angle_deltas=(-2, 0, 2), enable_cdef=True,
                  enable_interp_filter_search=True)
    elif preset == 2:     # M2
        kw.update(fixed_partition_size=None, nfl=2, angle_deltas=(0,))
    # M3+ keep partition RD at every preset — like the reference's
    # signal_derivation ladder (EbModeDecisionConfigurationProcess.c:926)
    # the budget shrinks (depth window, NFL, candidate counts, rect arms)
    # instead of pinning a fixed grid
    elif preset == 3:     # M3
        kw.update(fixed_partition_size=None, min_partition_size=8,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2, 9, 12))
    elif preset == 4:     # M4
        kw.update(fixed_partition_size=None, min_partition_size=16,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2, 12))
    elif preset == 5:     # M5
        kw.update(fixed_partition_size=None, min_partition_size=16,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2, 12),
                  enable_rect_partitions=False)
    elif preset == 6:     # M6
        kw.update(fixed_partition_size=None, min_partition_size=32,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2), enable_rect_partitions=False)
    elif preset == 7:     # M7
        kw.update(fixed_partition_size=None, min_partition_size=32,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0,), enable_rect_partitions=False,
                  scene_change_detection=False)
    else:                 # M8: fastest
        kw.update(fixed_partition_size=None, min_partition_size=32,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0,), enable_rect_partitions=False,
                  enable_dlf=False, scene_change_detection=False)
    # tile columns by resolution (the reference's segment fan-out): cuts
    # the wavefront scan critical path and parallelizes host entropy;
    # explicit tile_columns/tile_rows override
    tc, tr = a["tile_columns"], a["tile_rows"]
    if tc is None:
        tc = 2 if a["width"] >= 1920 else (1 if a["width"] >= 1280 else 0)
    kw.update(tile_cols_log2=tc, tile_rows_log2=tr or 0)
    if a["hierarchical_levels"]:
        kw.update(hierarchical_levels=a["hierarchical_levels"])
    if a["tbr"]:
        kw.update(rate_control_mode=RateControlMode.VBR,
                  target_bit_rate=a["tbr"], look_ahead_distance=a["lad"])
    kw.update(device=a["device"])
    if a["qp_file"]:
        with open(a["qp_file"]) as fh:
            kw.update(qp_file=tuple(
                int(line.split()[0]) for line in fh if line.strip()))
    return EncoderConfig(**kw)
