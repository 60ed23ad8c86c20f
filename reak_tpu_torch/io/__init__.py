"""I/O (port of ``reak_tpu.io``): tabular data recorders, scene
serialization, the config system, the native recorder data plane and the
profiler (``io.profiling``)."""
from reak_tpu_torch.io.config import Config, config_from_args, \
    config_from_file
from reak_tpu_torch.io.recorder import (BinaryRecorder, CsvRecorder,
                                        MemoryRecorder, NetworkServer,
                                        Recorder, TcpRecorder, UdpRecorder,
                                        open_extractor, open_recorder)
from reak_tpu_torch.io.serialization import (from_document, load_scene,
                                             register_type, save_scene,
                                             to_document)
from reak_tpu_torch.io import native_recorder
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
    "register_type",
    "save_scene",
    "load_scene",
    "to_document",
    "from_document",
    "Config",
    "config_from_args",
    "config_from_file",
]
