"""Recognition and the voice session: Recognizer, VAD, speaker
verification, diarization, the session FSM, tokenizer, hotwords, LM."""
