"""Channels: fixed-shape zero-copy pipes between processes.

Parity: python/ray/experimental/channel/ — the reference backs compiled
graphs with mutable plasma objects (shared_memory_channel.py:151) and
NCCL buffers (torch_tensor_nccl_channel.py). Here:

- ``ShmChannel``: a single-producer single-consumer ring over
  multiprocessing.shared_memory for fixed-dtype/shape numpy payloads —
  the host analogue of the reference's mutable plasma channel; writes
  and reads are memcpy into mapped memory, no serialization, no
  control-plane round trip.
- The port has no device channel (the reference's NCCL channels):
  payloads are host arrays, and a stage that runs on the card copies its
  input to the card itself.
"""

from .shm_channel import ShmChannel

__all__ = ["ShmChannel"]
