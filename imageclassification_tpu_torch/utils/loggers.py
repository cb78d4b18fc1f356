"""Training loggers (port of the JAX package's `utils/loggers.py`): the
TensorBoard sink (tensorboardX when it imports, else
torch.utils.tensorboard, else a no-op writer, so training never needs the
package) and the W&B logger (`--enable_wandb`; the `wandb` package is
imported only when one is made). At a world of several processes
`train.main` and `seg_train.main` make them on rank 0 only, as JAX's."""

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


class WandbLogger:
    """W&B logger: lazy import, batch-wise metrics keyed to
    global_train_step (logged by `engine.loop`), epoch metrics split into
    Global Train/ and Global Test/, an optional upload of the checkpoint
    directory as an artifact."""

    def __init__(self, args):
        self.args = args
        try:
            import wandb  # type: ignore

            self._wandb = wandb
        except ImportError:
            raise ImportError("To use the Weights and Biases Logger please install wandb.")
        if self._wandb.run is None:
            self._wandb.init(project=args.project,
                             config=args.to_dict() if hasattr(args, "to_dict") else vars(args))

    def log_epoch_metrics(self, metrics, commit=True):
        # 'epoch' is the step metric set_steps() declares for the Global
        # metrics, so it is logged with them; n_parameters goes to the summary
        if "epoch" in metrics:
            self._wandb.log({"epoch": metrics["epoch"]}, commit=False)
        if "n_parameters" in metrics and self._wandb.run is not None:
            self._wandb.run.summary["n_parameters"] = metrics["n_parameters"]
        for k, v in metrics.items():
            if k in ("epoch", "n_parameters"):
                continue
            if "train" in k:
                self._wandb.log({f"Global Train/{k}": v}, commit=False)
            elif "test" in k:
                self._wandb.log({f"Global Test/{k}": v}, commit=False)
        self._wandb.log({}, commit=commit)

    def log_checkpoints(self):
        artifact = self._wandb.Artifact(self._wandb.run.id + "_model", type="model")
        artifact.add_dir(self.args.output_dir)
        self._wandb.log_artifact(artifact, aliases=["latest", "best"])

    def set_steps(self):
        self._wandb.define_metric("Rank-0 Batch Wise/*",
                                  step_metric="Rank-0 Batch Wise/global_train_step")
        self._wandb.define_metric("Global Train/*", step_metric="epoch")
        self._wandb.define_metric("Global Test/*", step_metric="epoch")
