"""Native (C++) runtime components (counterpart of
``paddle_tpu/core``).

The data-reader core (``csrc/dataio.cpp``) and the rendezvous store
(``csrc/tcp_store.cpp``), the reference's code, are compiled on first
use with the system's ``g++`` into one library loaded through ctypes.
Their consumers, ``io.TokenFileLoader`` and ``distributed.TCPStore``,
keep the reference's python paths for a host without a compiler.
"""
from .build import load_native

__all__ = ["load_native"]
