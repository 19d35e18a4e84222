"""I/O: WAV/AIFF audio files and JSON run configuration."""
from .config import RunConfig, load_config, parse_config
from .wav import read_aiff, read_audio, read_wav, resample, write_wav

__all__ = [
    "RunConfig", "load_config", "parse_config",
    "read_aiff", "read_audio", "read_wav", "resample", "write_wav",
]
