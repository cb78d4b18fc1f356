"""A rank of a two-process run of the port over gloo on the CPU, for
tests/test_torch_distributed.py and tests/test_torch_seg_multiprocess.py.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py <job.pt> <out_dir>

It joins the group the way `train.main` does (torchrun's convention, through
`parallel.init_distributed_mode`), runs the jobs of <job.pt> (torch.save of
{"jobs": [name, ...], ...inputs}) and writes what it saw to
<out_dir>/rank<r>.pt. It imports the port alone: no JAX, nothing of the JAX
package (the parent test holds the results against them)."""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def run_steps(case):
    """The port's train step on this rank's rows of the case's global
    batches, fed the global batch's draws; the per-step metrics and the
    final state."""
    from imageclassification_tpu_torch import train as port_train
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.state import create_train_state
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.models import resnet as port_resnet
    from imageclassification_tpu_torch.models import vit as port_vit
    from imageclassification_tpu_torch.optim.factory import create_optimizer
    from imageclassification_tpu_torch.parallel.mesh import rows_of

    pargs, nc = case["args"], case["num_classes"]
    if case["family"] == "vit":
        model = port_vit.ViT(**case["vit"], img_size=case["img"], flash_attn=True)
    else:
        model = port_resnet.ResNet([1, 1, 1, 1], port_resnet.Bottleneck, num_classes=nc, width=8)
    model.load_state_dict(case["state_dict"])
    opt = create_optimizer(pargs.opt, model.parameters(), lr=pargs.lr,
                           weight_decay=pargs.weight_decay, opt_eps=pargs.opt_eps,
                           clip_grad=pargs.clip_grad, **port_train.optimizer_layout(pargs, model))
    state = create_train_state(model, opt, use_ema=True, update_freq=pargs.update_freq)
    step = build_train_step(model, pargs, nc, build_mixup(pargs, nc), case["lr_sched"],
                            case["wd_sched"], ema_decay=pargs.model_ema_decay)
    mine = rows_of(case["images"].shape[1])
    metrics = []
    for s, draws in enumerate(case["draws"]):
        batch = {"image": torch.from_numpy(case["images"][s][mine]),
                 "label": torch.from_numpy(case["labels"][s][mine])}
        m = step(state, batch, draws)
        metrics.append({k: np.asarray(m[k]) for k in m})
    return {"metrics": metrics,
            "params": {k: v.detach().clone() for k, v in model.named_parameters()},
            "buffers": {k: v.clone() for k, v in model.named_buffers()},
            "ema": {k: v.clone() for k, v in state.ema.items()},
            "ema_stats": {k: v.clone() for k, v in (state.ema_stats or {}).items()},
            "moments": {k: [t.clone() for t in ts] for k, ts in opt.moments.items()}}


def collectives(job, args, out_dir):
    """any_process, print gating, the metric sync, the resume broadcast and
    its FileNotFoundError, the checkpoint fingerprint, the mesh check."""
    from imageclassification_tpu_torch.checkpoint import io as ckpt_io
    from imageclassification_tpu_torch.parallel import any_process, check_mesh
    from imageclassification_tpu_torch.utils.metrics import MetricLogger, SmoothedValue

    rank = args.rank
    res = {"any_one": any_process(rank == 1), "any_none": any_process(False)}
    print(f"RANK{rank} gated line", flush=True)
    print(f"RANK{rank} forced line", flush=True, force=True)
    v = SmoothedValue()
    v.update(float(rank + 1), n=2)  # rank 0: 1.0 x 2, rank 1: 2.0 x 2
    logger = MetricLogger()
    logger.update(loss=float(rank))
    v.synchronize_between_processes()
    logger.synchronize_between_processes()
    res["sync"] = (v.count, v.global_avg, logger.loss.count, logger.loss.global_avg)
    # the resume decision: rank 0's path, adopted by rank 1, which had none
    path = os.path.join(out_dir, "resume.pth")
    a = type("A", (), {})()
    a.resume = path if rank == 0 else ""
    ckpt_io.sync_resume_across_processes(a)
    res["resume"] = a.resume
    a.resume = os.path.join(out_dir, "missing.pth") if rank == 0 else path
    try:
        ckpt_io.sync_resume_across_processes(a)
        res["missing"] = None
    except FileNotFoundError as e:
        res["missing"] = str(e)
    # the copies' fingerprint: the same copy (a NaN in it) passes, another raises
    same = {"w": np.array([1.0, np.nan, 2.5], np.float32)}
    ckpt_io.assert_checkpoint_consistent(same)
    other = {"w": np.array([1.0, float(rank), 2.5], np.float32)}
    try:
        ckpt_io.assert_checkpoint_consistent(other)
        res["fingerprint"] = None
    except RuntimeError as e:
        res["fingerprint"] = str(e)
    res["mesh"] = [check_mesh(m, args.world_size) for m in ("", "data:2", "data:1,fsdp:2")]
    try:
        check_mesh("data:4", args.world_size)
        res["mesh_error"] = None
    except ValueError as e:
        res["mesh_error"] = str(e)
    return res


def sharded_eval(job):
    """`engine.loop.evaluate` over this rank's shard of a val set of
    job["n_val"] samples at local batch job["eval_bs"] (`eval_batches`),
    the eval step of the step case's model."""
    from imageclassification_tpu_torch.data.sampler import eval_batches
    from imageclassification_tpu_torch.engine.loop import evaluate
    from imageclassification_tpu_torch.engine.step import build_eval_step
    from imageclassification_tpu_torch.models import vit as port_vit
    from imageclassification_tpu_torch.parallel import get_rank, get_world_size

    ev = job["eval"]
    model = port_vit.ViT(**ev["vit"], img_size=ev["img"], flash_attn=True)
    model.load_state_dict(ev["state_dict"])
    images, labels = ev["images"], ev["labels"]
    batches, seen = [], []
    for idx in eval_batches(len(labels), ev["eval_bs"], rank=get_rank(), world=get_world_size()):
        seen.extend(int(i) for i in idx if i >= 0)
        safe = np.maximum(idx, 0)
        batches.append({"image": torch.from_numpy(images[safe]),
                        "label": torch.from_numpy(np.where(idx >= 0, labels[safe], -1))})
    stats = evaluate(build_eval_step(model, ev["num_classes"]), batches, ev["num_classes"])
    return {"stats": stats, "seen": seen}


def seg_eval(job):
    """The port's `sharded_whole_eval` (global batch job["batch"]) with the
    eval step of a tiny (main, aux) model on the val pairs of job["seg_dir"]."""
    from imageclassification_tpu_torch.downstream.seg_data import scan_pairs
    from imageclassification_tpu_torch.downstream.seg_engine import (build_seg_eval_step,
                                                                      sharded_whole_eval)

    se = job["seg_eval"]
    model = tiny_seg_model(se["num_classes"])
    model.load_state_dict(se["state_dict"])
    pairs = scan_pairs(se["seg_dir"], "validation")
    return sharded_whole_eval(build_seg_eval_step(model, se["num_classes"]), pairs, se["crop"],
                              se["batch"], se["num_classes"], torch.device("cpu"))


def tiny_seg_model(num_classes):
    """A 3x3 conv, ReLU and a 1x1 classifier on NHWC images, returning
    (main logits, None) as UPerNet does."""
    from torch import nn

    class TinyHead(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(3, 8, 3, padding=1)
            self.cls = nn.Conv2d(8, num_classes, 1)

        def forward(self, x, generator=None):
            h = torch.relu(self.conv(x.permute(0, 3, 1, 2)))
            return self.cls(h).permute(0, 2, 3, 1), None

    return TinyHead()


def narrow_upernet(num_classes, seed=1):
    """A UPerNet over a narrow ConvNeXt (depths 1, dims 16-128, drop path 0),
    channels 32, the heads' dropout 0, fp32."""
    from imageclassification_tpu_torch.downstream.upernet import UPerNet
    from imageclassification_tpu_torch.models.convnext import ConvNeXt

    g = torch.Generator().manual_seed(seed)
    backbone = ConvNeXt(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), num_classes=0,
                        layer_scale_init=0.3, features_only=True, generator=g)
    model = UPerNet(backbone, num_classes=num_classes, channels=32, generator=g)
    for m in (model.decode_head, model.auxiliary_head):
        m.dropout = 0.0
    return model


def seg_step(job):
    """One UPerNet train iteration (`build_seg_train_step`, AdamW with the
    stage-wise scales) on this rank's rows of a global batch; the loss, the
    parameters, AdamW's first moments and the BatchNorm statistics after."""
    from imageclassification_tpu_torch.downstream.seg_engine import (build_seg_train_step,
                                                                      create_seg_optimizer,
                                                                      seg_decay_scales)
    from imageclassification_tpu_torch.engine.state import TrainState
    from imageclassification_tpu_torch.parallel.mesh import rows_of

    st = job["seg_step"]
    model = narrow_upernet(st["num_classes"])
    model.load_state_dict(st["state_dict"])
    opt = create_seg_optimizer(model, st["lr"], st["wd"],
                               seg_decay_scales(model, "stage_wise", 0.9, 6))
    state = TrainState(model=model, optimizer=opt)
    step = build_seg_train_step(model, np.full(4, st["lr"]), st["wd"])
    mine = rows_of(st["images"].shape[0])
    loss = step(state, torch.from_numpy(st["images"][mine]), torch.from_numpy(st["labels"][mine]))
    return {"loss": float(loss), "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "moments": {k: [t.clone() for t in ts] for k, ts in opt.moments.items()}}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: list, world: int = 2, timeout: float = 300, cwd: str = None) -> list:
    """Run `argv` (after the interpreter) as `world` ranks of one group in
    torchrun's environment (a free port, one thread each, no PYTHONPATH);
    returns each rank's output. Raises with a rank's output when it fails."""
    import subprocess

    port = str(free_port())
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} exited with {p.returncode}:\n{text}")
    return outs


def launch(job: dict, out_dir: str, world: int = 2, timeout: float = 300) -> list:
    """Run this file as `world` ranks of one gloo group on `job`; returns
    each rank's (results, output)."""
    os.makedirs(out_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.pt")
    torch.save(job, job_path)
    outs = spawn([os.path.abspath(__file__), job_path, out_dir], world, timeout)
    return [(torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False), outs[r])
            for r in range(world)]


def main(job_path, out_dir):
    from imageclassification_tpu_torch.config import TrainConfig
    from imageclassification_tpu_torch.parallel import init_distributed_mode

    job = torch.load(job_path, weights_only=False)
    args = TrainConfig(device="cpu")
    init_distributed_mode(args)
    out = {"init": (args.distributed, args.rank, args.world_size, args.local_rank)}
    for name in job["jobs"]:
        if name == "collectives":
            out[name] = collectives(job, args, out_dir)
        elif name == "steps":
            out[name] = {case: run_steps(c) for case, c in job["cases"].items()}
        elif name == "eval":
            out[name] = sharded_eval(job)
        elif name == "seg_eval":
            out[name] = seg_eval(job)
        elif name == "seg_step":
            out[name] = seg_step(job)
    with tempfile.NamedTemporaryFile(dir=out_dir, delete=False) as f:
        torch.save(out, f)
    os.replace(f.name, os.path.join(out_dir, f"rank{args.rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
