"""TensorBoard sink (port of the JAX package's `utils/loggers.py`
TensorboardLogger): tensorboardX when it imports, else
torch.utils.tensorboard, else a no-op writer, so training never needs the
package. The W&B logger is not ported yet (ROADMAP A6)."""

from __future__ import annotations


class TensorboardLogger:
    """SummaryWriter wrapper with a manual global-step counter and `head/key`
    scalar names."""

    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter  # type: ignore

            self.writer = SummaryWriter(logdir=log_dir)
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore

                self.writer = SummaryWriter(log_dir=log_dir)
            except ImportError:
                print("tensorboardX not available — TensorBoard logging disabled")
                self.writer = None
        self.step = 0

    def set_step(self, step=None):
        if step is not None:
            self.step = step
        else:
            self.step += 1

    def update(self, head="scalar", step=None, **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is None:
                continue
            if hasattr(v, "item"):
                v = v.item()
            self.writer.add_scalar(head + "/" + k, v, self.step if step is None else step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
