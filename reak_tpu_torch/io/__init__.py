"""I/O (port of ``reak_tpu.io``): tabular data recorders and the config
system.  Scene serialization, the native recorder and the profiler are not
ported yet."""
from reak_tpu_torch.io.config import Config, config_from_args, \
    config_from_file
from reak_tpu_torch.io.recorder import (BinaryRecorder, CsvRecorder,
                                        MemoryRecorder, NetworkServer,
                                        Recorder, TcpRecorder, UdpRecorder,
                                        open_extractor, open_recorder)

__all__ = [
    "Recorder",
    "MemoryRecorder",
    "CsvRecorder",
    "BinaryRecorder",
    "TcpRecorder",
    "UdpRecorder",
    "NetworkServer",
    "open_recorder",
    "open_extractor",
    "Config",
    "config_from_args",
    "config_from_file",
]
