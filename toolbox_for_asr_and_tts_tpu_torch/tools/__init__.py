"""Operations tools of the port: checkpoint conversion with its
round-trip diff (`convert_checkpoint`), the model-cache report
(`check_cache`), and the yardsticks of a precision change: transcript CER
(`wer`) and the log-mel distance of two waveforms (`mel_distance`)."""
