"""Operations tools of the port: checkpoint conversion with its
round-trip diff (`convert_checkpoint`), the model-cache report
(`check_cache`), the mount rehearsal (`rehearse`: strict conversion of
every family, both services booted and driven; `cli rehearse`), the
yardsticks of a precision change: transcript CER (`wer`) and the log-mel
distance of two waveforms (`mel_distance`), the diarization error rate
(`der`), and the generator of the frontend's external goldens
(`make_frontend_goldens`, a CPU tool that needs `transformers`)."""
