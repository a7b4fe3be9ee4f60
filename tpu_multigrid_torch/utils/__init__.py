from . import checkpoint, compile, convert, io, native  # noqa: F401
