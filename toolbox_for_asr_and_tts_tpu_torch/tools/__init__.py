"""Operations tools of the port: checkpoint conversion with its
round-trip diff (`convert_checkpoint`) and the model-cache report
(`check_cache`)."""
