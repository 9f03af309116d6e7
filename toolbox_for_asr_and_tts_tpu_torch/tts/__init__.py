"""The port's TTS: text front end (copied), Sambert + HiFi-GAN synthesis on
the card, segment concatenation and the async job manager."""
from .concat import concat_segments, crossfade_concat
from .jobs import TTSJobManager
from .synthesizer import Synthesizer
from .text_frontend import (G2P, LingVocab, PhoneVocab, normalize_text,
                            pause_after, split_text_for_tts)

__all__ = ["concat_segments", "crossfade_concat", "TTSJobManager",
           "Synthesizer", "G2P", "LingVocab", "PhoneVocab", "normalize_text",
           "pause_after", "split_text_for_tts"]
