"""toolbox_for_asr_and_tts_tpu_torch — the PyTorch/CUDA port of the speech
toolbox, for NVIDIA Hopper (H100).

The JAX package `toolbox_for_asr_and_tts_tpu` beside it is the reference;
this package imports nothing of it (nor JAX) and keeps its own copies of the
framework-free pieces it needs. Module paths and public names mirror the
reference so that each module's counterpart is easy to find:

    device.py          explicit device resolution (CUDA unless told "cpu")
    csrc/              hand-written CUDA C++ kernels for sm_90a
    ops/kernels/       their build step, ctypes wrappers, plain versions, counters
    ops/nn.py          functional layers over the reference's param tree
    ops/frontend.py    fbank → LFR → CMVN
    models/            Paraformer, and the numpy → torch param converter
    runtime/           bucketing, RTF metrics
    asr/               tokenizer, hotword bias, n-gram LM, Recognizer
"""
