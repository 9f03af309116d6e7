"""Model families of the port (functional init/forward over tensor trees
with the reference's keys and layouts), and the converter from the
reference's numpy parameter tree (`convert.py`).

| module | capability | reference model |
|---|---|---|
| fsmn_vad | streaming VAD | speech_fsmn_vad_zh-cn-16k-common |
| paraformer | offline NAR ASR | speech_paraformer-large_…vocab8404 |
| paraformer_streaming | online ASR | …vocab8404-online |
| ct_transformer | punctuation | punc_ct-transformer_…-large |
| campplus | speaker embeddings | speech_campplus_sv_zh-cn_16k-common |
| kws_ctc | wake word | speech_charctc_kws_phone-xiaohu |
| sambert | TTS acoustic | speech_sambert-hifigan_tts (acoustic) |
| hifigan | vocoder | speech_sambert-hifigan_tts (vocoder) |
"""
from . import (campplus, ct_transformer, fsmn_vad, hifigan, kws_ctc,
               paraformer, paraformer_streaming, sambert)

__all__ = ["campplus", "ct_transformer", "fsmn_vad", "hifigan", "kws_ctc",
           "paraformer", "paraformer_streaming", "sambert"]
