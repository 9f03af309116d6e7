"""Recognition and the voice session: Recognizer, VAD, speaker
verification, diarization, the session FSM, tokenizer, hotwords, LM, ITN."""
from .corrections import apply_hard_corrections, is_punct_only
from .hotwords import (banned_words, hotwords_json, load_hotwords_from_file,
                       normalize_hotwords, positive_hotword_list)
from .itn import apply_itn
from .tokenizer import CharTokenizer, join_tokens

__all__ = [
    "apply_hard_corrections", "is_punct_only", "banned_words",
    "hotwords_json", "load_hotwords_from_file", "normalize_hotwords",
    "positive_hotword_list", "apply_itn", "CharTokenizer", "join_tokens",
]
