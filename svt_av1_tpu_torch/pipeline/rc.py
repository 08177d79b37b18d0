"""Rate control: VBR with per-temporal-layer budgets and a GOP model.

The reference's RC stage (EbRateControlProcess.c:349
HighLevelRcInputPictureMode2: lookahead-driven budgets;
RateControlModel.c:61-196: GOP-level allocation and correction)
redesigned as frame-granular feedback (SURVEY.md §7.4.5: avoid
fine-grained device ping-pong). Three cooperating loops:

- per-layer targets: each temporal layer gets a share of the GOP budget
  (anchors more, leaf Bs less — the reference's
  rate_percentage_layer_array role); a learned per-layer qindex delta
  tracks how the content actually spends against those shares.
- local loop: base qindex moves proportionally to log2(actual/target)
  of each coded frame.
- long-run loop: the unclamped bit debt (spent - coded*budget) is
  repaid over a fixed horizon — each frame's target is reduced by
  debt/horizon, and a pressure term nudges qindex directly. This is
  what drives the *average* rate to the ±N% contract.
"""

from __future__ import annotations

import numpy as np

# GOP-share weights per temporal layer (layer 0 = anchor/P). Anchors get
# ~3x a leaf-B budget, mirroring the reference's per-layer percentages.
_LAYER_W = (1.9, 1.15, 0.85, 0.6, 0.5, 0.45)
# ~24 qindex steps halve the bitrate (the qindex scale is exponential
# in quantizer step); used to seed per-layer deltas from the weights.
_STEPS_PER_OCTAVE = 24.0


def _layer_weights(levels: int):
    """Normalized per-layer weights: a GOP of 2**levels frames has one
    layer-0 anchor, one layer-1 mid, 2 layer-2, ... 2**(levels-1)
    leaves; normalize so the weighted GOP total equals the flat total."""
    if levels <= 0:
        return (1.0,)
    counts = [1] + [1 << max(i - 1, 0) for i in range(1, levels + 1)]
    w = np.array(_LAYER_W[:levels + 1], dtype=np.float64)
    w *= sum(counts) / float(np.dot(counts, w))
    return tuple(w)


class RateControl:
    """Per-layer VBR controller with debt repayment + GOP correction."""

    KEY_BOOST = 3.0      # keyframes get ~3x a layer-0 budget
    REPAY_SECONDS = 0.8  # horizon over which accumulated debt is repaid

    def __init__(self, target_bps: float, fps: float,
                 intra_period: int = -1, start_qindex: int = 120,
                 hierarchical_levels: int = 0):
        self.fps = fps
        self.frame_budget = target_bps / fps
        self.q = float(start_qindex)
        self.spent = 0.0           # total bits coded so far
        self.coded = 0             # frames coded so far
        self.norm = target_bps     # one second of bits (pressure scale)
        self.weights = _layer_weights(hierarchical_levels)
        # learned per-layer qindex deltas, seeded from the bit shares
        self.layer_dq = [-_STEPS_PER_OCTAVE * float(np.log2(w))
                         for w in self.weights]
        self._n = 0
        # GOP model: the correction spreads surplus/deficit over what
        # remains of the current GOP
        self._gop_len = (intra_period + 1) if intra_period > 0 else 0
        self._gop_spent = 0.0
        self._gop_frames = 0
        self._la_share = 1.0

    # --- lookahead model ------------------------------------------------------
    def set_lookahead(self, complexities) -> None:
        """Receive the lookahead complexity window for the next frame
        (HighLevelRcInputPictureMode2's histogram role): the head
        frame's share of the window average scales its bit target."""
        if not complexities:
            self._la_share = 1.0
            return
        c = float(complexities[0])
        mean = float(np.mean(complexities))
        self._la_share = float(np.clip(c / max(mean, 1e-3), 0.5, 2.0))

    # --- targets --------------------------------------------------------------
    def _debt(self) -> float:
        """Bits spent beyond the pro-rata stream budget (unclamped — a
        big keyframe must eventually be paid for)."""
        return self.spent - self.coded * self.frame_budget

    def budget_for(self, is_key: bool, layer: int = 0) -> float:
        if is_key:
            return self.frame_budget * self.KEY_BOOST
        w = self.weights[min(layer, len(self.weights) - 1)]
        return self.frame_budget * w * self._la_share

    def _adj_target(self, is_key: bool, layer: int) -> float:
        """Per-frame target after debt repayment: debt is amortized over
        REPAY_SECONDS so the stream average converges to the contract."""
        t = self.budget_for(is_key, layer)
        repay = self._debt() / (self.REPAY_SECONDS * self.fps)
        return max(t - repay, 0.05 * t)

    def _gop_correction(self) -> float:
        """Remaining-GOP correction in qindex steps: if the GOP has
        overspent its pro-rata budget, push q up for its remaining
        frames (RateControlModel.c account_for_past_frames role)."""
        if not self._gop_len or not self._gop_frames:
            return 0.0
        expect = self.frame_budget * self._gop_frames
        over = (self._gop_spent - expect) / max(expect, 1.0)
        return float(np.clip(12.0 * over, -14.0, 14.0))

    def frame_qindex(self, is_key: bool, complexity: float = 1.0,
                     layer: int = 0) -> int:
        """complexity: lookahead weight (1.0 = average frame; > 1 means
        the lookahead saw this frame is harder — spend proportionally
        more bits by lowering q)."""
        q = self.q
        if is_key:
            q -= 18.0              # pyramid offset for keys
        else:
            q += self.layer_dq[min(layer, len(self.layer_dq) - 1)]
        # debt pressure: one second of debt pushes q up ~56 steps
        q += 56.0 * np.clip(self._debt() / max(self.norm, 1), -1, 1)
        q += self._gop_correction()
        if complexity != 1.0:
            q -= 14.0 * np.log2(np.clip(complexity, 0.5, 2.0))
        return int(np.clip(round(q), 1, 255))

    def update(self, actual_bits: float, is_key: bool,
               layer: int = 0) -> None:
        target = self._adj_target(is_key, layer)
        ratio = max(actual_bits, 1.0) / max(target, 1.0)
        # proportional step on the base q, stronger while converging
        gain = 14.0 if self._n < 8 else 7.0
        self.q = float(np.clip(self.q + gain * np.log2(ratio), 1, 255))
        if not is_key:
            # per-layer correction: how this layer spends vs its share,
            # relative to the global loop
            li = min(layer, len(self.layer_dq) - 1)
            self.layer_dq[li] = float(np.clip(
                self.layer_dq[li] + 3.0 * np.log2(ratio), -30.0, 60.0))
        self.spent += actual_bits
        self.coded += 1
        # GOP accounting
        if is_key:
            self._gop_spent = 0.0
            self._gop_frames = 0
        self._gop_spent += actual_bits
        self._gop_frames += 1
        if self._gop_len and self._gop_frames >= self._gop_len:
            self._gop_spent = 0.0
            self._gop_frames = 0
        self._n += 1
