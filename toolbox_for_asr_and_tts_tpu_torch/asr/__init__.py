"""Offline recognition: Recognizer, tokenizer, hotword bias, n-gram LM."""
