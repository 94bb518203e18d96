"""Progressive-growing schedule as a pure function (ProGAN sec. 3).

A copy of ``ganlab_tpu/train/schedule.py`` over the port's own config.

The reference's ``ProGANLearner`` advances a mutable state machine per shown
image (SURVEY.md 2.2). Here the entire plan is computed up front as a list of
``PhaseSpec`` rows, and the current phase / fade-in alpha are pure functions
of the shown-image counter — trivially checkpointable and testable against a
hand-computed golden table (SURVEY.md 4).

Plan layout for start_res=4, resolution=16:

    res 4   stabilize   [0, s)
    res 8   fade        [s, s+f)        alpha = (shown - s) / f
    res 8   stabilize   [s+f, 2s+f)
    res 16  fade        [2s+f, 2s+2f)
    res 16  stabilize   [2s+2f, 3s+2f)   (final phase extends to total_kimg)

with s = stabilize_kimg*1000 and f = fade_kimg*1000 images.
"""

from __future__ import annotations

from dataclasses import dataclass

from ganlab_tpu_torch.config import ModelConfig, ScheduleConfig, res_to_log2


@dataclass(frozen=True)
class PhaseSpec:
    index: int
    res_log2: int              # output resolution = 2**res_log2
    kind: str                  # 'fade' | 'stabilize'
    start_img: int             # first shown-image count in this phase
    end_img: int               # exclusive; final phase: schedule end
    batch_size: int            # per-device batch size for this resolution

    @property
    def resolution(self) -> int:
        return 2 ** self.res_log2

    @property
    def fade_images(self) -> int:
        return self.end_img - self.start_img if self.kind == "fade" else 0


def build_phases(sched: ScheduleConfig, model: ModelConfig) -> list[PhaseSpec]:
    """The full progressive plan; a single stabilize phase if not progressive."""
    total = int(sched.total_kimg * 1000)
    max_lg = model.res_log2
    if not sched.progressive:
        lg = max_lg
        return [PhaseSpec(0, lg, "stabilize", 0, total,
                          sched.batch_for(2 ** lg))]

    start_lg = res_to_log2(sched.start_res)
    fade = int(sched.fade_kimg * 1000)
    stab = int(sched.stabilize_kimg * 1000)

    phases: list[PhaseSpec] = []
    cursor = 0
    idx = 0
    for lg in range(start_lg, max_lg + 1):
        bs = sched.batch_for(2 ** lg)
        if lg > start_lg:
            phases.append(PhaseSpec(idx, lg, "fade", cursor, cursor + fade, bs))
            cursor += fade
            idx += 1
        end = cursor + stab
        phases.append(PhaseSpec(idx, lg, "stabilize", cursor, end, bs))
        cursor = end
        idx += 1
    # The final stabilize phase absorbs any remaining budget.
    last = phases[-1]
    end = max(last.end_img, total)
    phases[-1] = PhaseSpec(last.index, last.res_log2, last.kind,
                           last.start_img, end, last.batch_size)
    return phases


def phase_at(phases: list[PhaseSpec], shown_imgs: int) -> PhaseSpec:
    """The phase covering a shown-image count (end-inclusive on the last)."""
    for p in phases:
        if shown_imgs < p.end_img:
            return p
    return phases[-1]


def alpha_at(phase: PhaseSpec, shown_imgs) -> float:
    """Host-side fade-in alpha of a phase at a shown-image count."""
    if phase.kind != "fade":
        return 1.0
    return min(max((shown_imgs - phase.start_img) / phase.fade_images, 0.0),
               1.0)
