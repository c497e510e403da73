"""Zero-shot (image-only) SVD worker: no action conditioning.

Port of `wiw_tpu/workers/svd_zero_shot.py`: the stock SVD img2vid pipeline
behind the serving contract; actions are accepted but unused (the
zero-shot baseline of the WM zoo).
"""

from __future__ import annotations

from wiw_tpu_torch.workers.svd_action import SVDActionWorker, main as _main


class SVDZeroShotWorker(SVDActionWorker):
    def __init__(self, **kw):
        kw.setdefault("action_strategy", None)
        kw.setdefault("task_type", "navigation")
        super().__init__(**kw)


def main(argv=None):
    _main((argv or []) + ["--action_strategy", ""])


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
