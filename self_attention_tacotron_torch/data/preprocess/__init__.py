from . import codes, ljspeech, vctk

__all__ = ["codes", "ljspeech", "vctk"]
