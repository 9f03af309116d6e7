"""Native (C++) pieces of the port: the FunASR WebSocket server, the WAV
ingest and the epoll load generator (copies of the reference's sources),
built with g++ at first use by `bridge.build_library` into the package's
`_native_build/`."""
