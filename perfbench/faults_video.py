"""The video train kind's planted faults (perfbench/faults.py's contract),
registered in faults.FAULTS when perfbench/traffic/video_train.py is imported:
the optimizer's unchanged state, reused, and a half batch on the video train
step."""

from __future__ import annotations

import contextlib

from perfbench import faults


@contextlib.contextmanager
def half_batch_video():
    """The video train step sees the first half of each batch."""
    from fvta_memexqa_torch import train_video

    step = train_video.video_train_step
    with faults._patched(train_video, "video_train_step", lambda state, opt, shared, vi, *a, **k:
                         step(state, opt, shared, faults._half(vi), *a, **k)):
        yield


faults.FAULTS["video_train"] = {"unchanged": faults.unchanged_state, "half": half_batch_video}
