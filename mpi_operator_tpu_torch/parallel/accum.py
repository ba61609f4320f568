"""The train step every model family shares, with gradient
accumulation (port of ``mpi_operator_tpu/parallel/accum.py``): one
optimizer step from ``accum_steps`` sequential microbatches, on one
device."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.torchtrace import timed_range

# The param-group key of the update count the LR schedule reads.
SCHEDULE_COUNT = "schedule_count"


def make_update_step(loss_of_batch: Optional[Callable], optimizer,
                     accum_steps: int = 1,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     forward_backward: Optional[Callable] = None):
    """``loss_of_batch(*batch) -> scalar`` becomes ``step(*batch) -> loss``:
    zero the gradients, backpropagate, one ``optimizer.step()``.

    ``accum_steps > 1``: every batch tensor's leading dim must divide by
    it; microbatch ``i`` is rows [i*b/A, (i+1)*b/A). The gradients are the
    mean of the microbatch gradients and the reported loss the mean of
    the microbatch losses -- the full-batch values when the loss is a
    mean over equal-sized microbatches.

    ``lr_schedule(count)``, when given, sets the learning rate before the
    ``count``-th update (count starts at 0), as an optax schedule does.
    The count lives in the optimizer's state, as optax keeps it in
    ``opt_state``: each param group's ``schedule_count`` (for AdamW and
    SGD alike; SGD keeps no step of its own), so it is saved and restored
    with the optimizer and a resumed run carries on from the step it
    stopped at.

    ``forward_backward(*batch) -> loss``, in place of ``loss_of_batch``,
    runs the backward itself (a pipeline's explicit schedule); the
    gradients are then its, from one batch.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    for group in optimizer.param_groups:
        group.setdefault(SCHEDULE_COUNT, 0)

    def train_step(*batch):
        optimizer.zero_grad(set_to_none=True)
        if forward_backward is not None:
            with timed_range("step.pipeline"):
                loss = forward_backward(*batch)
        elif accum_steps == 1:
            with timed_range("step.forward"):
                loss = loss_of_batch(*batch)
            with timed_range("step.backward"):
                loss.backward()
        else:
            for x in batch:
                if x.shape[0] % accum_steps:
                    raise ValueError(
                        f"batch dim {x.shape[0]} not divisible by "
                        f"accum_steps={accum_steps}"
                    )
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch[0].device)
            for i in range(accum_steps):
                mb = tuple(
                    x.reshape(accum_steps, x.shape[0] // accum_steps,
                              *x.shape[1:])[i]
                    for x in batch
                )
                with timed_range("step.forward"):
                    micro = loss_of_batch(*mb)
                with timed_range("step.backward"):
                    (micro / accum_steps).backward()
                loss = loss + micro.detach()
            loss = loss / accum_steps
        with timed_range("step.optimizer"):
            if lr_schedule is not None:
                lr = lr_schedule(optimizer.param_groups[0][SCHEDULE_COUNT])
                for group in optimizer.param_groups:
                    group["lr"] = lr
            optimizer.step()
        for group in optimizer.param_groups:
            group[SCHEDULE_COUNT] += 1
        return loss.detach()

    return train_step
