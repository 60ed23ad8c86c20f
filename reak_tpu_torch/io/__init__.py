"""I/O (port of ``reak_tpu.io``): tabular data recorders, the config
system and the profiler (``io.profiling``).  Scene serialization and the
native recorder are not ported yet."""
from reak_tpu_torch.io.config import Config, config_from_args, \
    config_from_file
from reak_tpu_torch.io.recorder import (BinaryRecorder, CsvRecorder,
                                        MemoryRecorder, NetworkServer,
                                        Recorder, TcpRecorder, UdpRecorder,
                                        open_extractor, open_recorder)
from reak_tpu_torch.io import profiling

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
