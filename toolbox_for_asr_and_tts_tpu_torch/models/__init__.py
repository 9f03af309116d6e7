"""Model families of the port (Paraformer so far) and the converter from the
reference's numpy parameter tree."""
