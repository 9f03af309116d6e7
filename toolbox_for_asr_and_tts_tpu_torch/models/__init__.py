"""Model families of the port (Paraformer offline and online, FSMN-VAD,
CT-Transformer, CAM++, KWS) and the converter from the reference's numpy
parameter tree."""
