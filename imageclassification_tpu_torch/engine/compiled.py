"""How the steps run on a card: captured once as CUDA graphs and replayed
(the port of the JAX package's `jax.jit` of the train step with the state
donated, `train.py:267-277`, of the eval step, `train.py:278`, and of
val.py's predict, `val.py:100`), or eagerly with NaN checks (the port of
`--check_nans`, JAX's `jax_debug_nans`).

A graph replays the device work of a step as one launch, so the host's cost
a step is the copy of the batch into the graph's input buffers and the
launch, not the enqueue of each kernel. What a capture needs and where it
comes from:
* no host read inside the step: the non-finite gate is on the device
  (`engine/step.py`), and the metrics leave in one packed vector, copied to
  pinned memory behind the replay (`StepMetrics`);
* fixed input buffers: the uint8 batch, the labels and the host-drawn
  inputs (the schedule index and the mixup draws, `host_inputs`) are copied
  into them before each replay;
* fresh random numbers at each replay: the step's CUDA generators (pixel
  draws, dropout and stochastic depth) are registered with each graph, which
  then advances their offsets at each replay as an eager step would, so a
  replayed step draws what the eager step would have drawn;
* lazy set-up done before capture: the first steps run eagerly on a side
  stream (cuBLAS workspaces, the kernels' libraries and shared-memory
  attributes, the tensor-map context of autograd's thread);
* memory at fixed addresses: each graph allocates from a private pool, and
  the kernels' tensor maps, encoded at capture, keep pointing into it;
* capture in `thread_local` mode, so the loader's threads, which pin host
  memory while a step is captured, do not invalidate the capture.

A capture that fails raises; nothing falls back to the eager step. On the
CPU the same functions run uncaptured.

These run at a world of one process only. At a world of several
(`parallel/`) `train.main` runs the train and eval steps eagerly, their
collectives inline (the gradient all-reduce, BatchNorm's statistics, the
mixup gather, the metrics): no host here can check an NCCL collective
inside a CUDA graph, and gloo's cannot be captured. Capturing the
multi-process step is held in ROADMAP.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from .step import EVAL_SCALARS, TRAIN_SCALARS, StepMetrics, to_device

# eager steps before the train step is captured (the optimizer's temporaries,
# the autograd thread's set-up and the kernels' first calls happen there)
TRAIN_WARMUP_STEPS = 2


def _on_side_stream(stream: torch.cuda.Stream, fn: Callable):
    """fn() on `stream`, ordered after the current stream's work and before
    what the current stream does next."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    return out


class Graphed:
    """fn(*tensors) -> tensor replayed from a CUDA graph captured for each
    input signature (shapes and dtypes), on `device`. Each call copies its
    tensors (on the device, or on the host) into the graph's input buffers
    and replays; it returns the graph's output buffer, which the next call
    overwrites. `generators`: the CUDA generators fn draws from. With
    `rehearse`, the first call of a signature runs fn once eagerly on a side
    stream before the capture (for a pure fn; a step that updates a state
    does its warm-up as real steps instead). `pool`: a memory pool to share
    with other graphs that are replayed one at a time."""

    def __init__(self, fn: Callable, device: torch.device, generators=(),
                 rehearse: bool = True, pool=None):
        self.fn, self.device, self.generators = fn, device, tuple(generators)
        self.rehearse, self.pool = rehearse, pool
        self._graphs: Dict[tuple, tuple] = {}
        self._side = torch.cuda.Stream(device)

    def _copy_in(self, buffers: Sequence[torch.Tensor], args: Sequence[torch.Tensor]) -> None:
        for buf, a in zip(buffers, args):
            buf.copy_(a.pin_memory() if a.device.type == "cpu" else a, non_blocking=True)

    def _capture(self, args: Sequence[torch.Tensor]) -> tuple:
        buffers = [torch.empty(a.shape, dtype=a.dtype, device=self.device) for a in args]
        self._copy_in(buffers, args)
        if self.rehearse:
            _on_side_stream(self._side, lambda: self.fn(*buffers))
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            out = self.fn(*buffers)
        self.pool = graph.pool()
        return graph, buffers, out

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(args)
        else:
            self._copy_in(entry[1], args)
        entry[0].replay()
        return entry[2]


class CapturedTrainStep:
    """The train step of `build_train_step` replayed from CUDA graphs: the
    first TRAIN_WARMUP_STEPS calls run the eager step on a side stream, then
    each kind of step (a window's boundary or a micro-step, as the step
    counter says) is captured at its first call and replayed from then on.
    The graphs are bound to the state of their capture; another state
    raises. Same call and result as the eager step; it takes no `draws`
    (it draws its own)."""

    def __init__(self, train_step: Callable, device: torch.device,
                 warmup: int = TRAIN_WARMUP_STEPS):
        self.step, self.device, self.warmup = train_step, device, warmup
        self._eager_calls = 0
        self._graphs: Dict[bool, Graphed] = {}
        self._state = None
        self._side = torch.cuda.Stream(device)

    def __call__(self, state, batch, draws: Optional[Dict] = None) -> StepMetrics:
        if draws is not None:
            raise ValueError("a captured train step draws its own random numbers; "
                             "call the eager step to pass draws")
        if self._state is not None and state is not self._state:
            raise ValueError("a captured train step is bound to the state it was captured on")
        step = self.step
        image, label = batch["image"], batch["label"]
        boundary = step.is_boundary(state.step)
        inputs = step.host_inputs(state.step, *image.shape[:3])
        if self._eager_calls < self.warmup:
            self._eager_calls += 1
            flat = _on_side_stream(self._side, lambda: step.device_step(
                state, image, label, to_device(inputs, self.device), boundary))
        else:
            graphed = self._graphs.get(boundary)
            if graphed is None:
                self._state = state
                pool = next(iter(self._graphs.values())).pool if self._graphs else None
                graphed = self._graphs[boundary] = Graphed(
                    lambda i, l, x: step.device_step(state, i, l, x, boundary), self.device,
                    step.generators, rehearse=False, pool=pool)
            flat = graphed(image, label, inputs)
        state.step += 1
        return StepMetrics(flat, TRAIN_SCALARS, step.num_classes)


def captured_eval_step(eval_step: Callable, device: torch.device) -> Callable:
    """`build_eval_step`'s eval_step replayed from a CUDA graph for each batch
    shape (eval batches are padded to one shape, so one graph)."""
    graphed = Graphed(eval_step.device_step, device)

    def step(batch: Dict[str, torch.Tensor]) -> StepMetrics:
        return StepMetrics(graphed(batch["image"], batch["label"]), EVAL_SCALARS,
                           eval_step.num_classes)

    return step


def captured_predict(predict: Callable, device: torch.device) -> Callable:
    """val.py's predict (uint8 images -> probabilities) replayed from a CUDA
    graph for each batch shape; returns a copy of the graph's output. The
    uncaptured function is its `eager` attribute."""
    graphed = Graphed(predict, device)

    def replay(images_u8: torch.Tensor) -> torch.Tensor:
        return graphed(images_u8).clone()

    replay.eager = predict
    return replay


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def nan_checked(train_step: Callable, model: nn.Module) -> Callable:
    """The eager train step with NaN checks (--check_nans; JAX's
    jax_debug_nans, which also runs the step op by op): a forward hook on
    every module raises FloatingPointError naming the first module whose
    output holds a NaN, autograd's anomaly detection checks the backward
    (its error raised again as FloatingPointError), and so is a NaN loss.
    Each check reads the device on the host."""
    names = {m: n or type(model).__name__ for n, m in model.named_modules()}

    def hook(module, inputs, output):
        if any(torch.isnan(t).any() for t in _tensors(output) if t.is_floating_point()):
            raise FloatingPointError(f"NaN in the output of {names[module]} "
                                     f"({type(module).__name__})")

    def checked(state, batch, draws=None) -> StepMetrics:
        handles = [m.register_forward_hook(hook) for m in model.modules()]
        try:
            with torch.autograd.detect_anomaly():
                metrics = train_step(state, batch, draws)
        except RuntimeError as e:
            if "returned nan values" not in str(e):
                raise
            raise FloatingPointError(str(e)) from e
        finally:
            for h in handles:
                h.remove()
        if math.isnan(metrics["loss"]):
            raise FloatingPointError("NaN loss")
        return metrics

    return checked
