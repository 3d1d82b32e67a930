"""The plain reference that decides ``correct``: NumPy and Python only.

Nothing here imports ``snappy_tpu_torch``, ``snappy_tpu`` or JAX, and
nothing takes a value that the program made.  ``crc32c`` computes the
framing format's masked CRC32C; ``snappy`` decodes a raw tag stream and
encodes a block as the level-1 greedy encoder does.
"""
