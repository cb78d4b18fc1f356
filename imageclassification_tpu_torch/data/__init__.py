"""Data path: folder index and split, epoch and eval index math, PIL decode
and the batch loader, the device pixel pipelines (train and eval), mixup."""
