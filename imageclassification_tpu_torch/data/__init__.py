"""Host data path: folder index, eval batch index math, PIL decode, and the
on-device eval pixel pipeline."""
