"""Error subsystem.

The port's own copy of ``sparsex_tpu/errors.py``,
with its imports pointed at ``sparsex_tpu_torch``: it behaves as the
reference does, so both packages plan alike.

Parity with the reference error layer (``include/sparsex/error.h:99-115``,
``src/api/error.c``): a table of error/warning codes with default messages, a
default handler that reports through the logger, and a user-replaceable
handler hook (``spx_err_set_handler``).  In Python the errors additionally
materialize as exceptions so callers can use either style.
"""

from __future__ import annotations

import enum
import inspect
from typing import Callable, Optional

from sparsex_tpu_torch.logger import log_error, log_warning


class ErrorCode(enum.IntEnum):
    """Error and warning codes (reference ``include/sparsex/error.h``)."""

    # Errors
    SPX_SUCCESS = 0
    SPX_FAILURE = 1
    SPX_ERR_ARG_INVALID = 2
    SPX_ERR_FILE = 3
    SPX_ERR_INPUT_MAT = 4
    SPX_ERR_TUNED_MAT = 5
    SPX_ERR_DIM = 6
    SPX_ERR_VEC_DIM = 7
    SPX_ERR_ENTRY_NOT_FOUND = 8
    SPX_ERR_OUT_OF_BOUNDS = 9
    SPX_ERR_SYSTEM = 10
    SPX_ERR_FILE_OPEN = 11
    SPX_ERR_FILE_READ = 12
    SPX_ERR_FILE_WRITE = 13
    SPX_ERR_MEM_ALLOC = 14
    SPX_ERR_MEM_FREE = 15
    # Warnings
    SPX_WARN_CSXFILE = 100
    SPX_WARN_TUNING_OPT = 101
    SPX_WARN_ENTRY_NOT_SET = 102
    SPX_WARN_REORDER = 103

    @property
    def is_warning(self) -> bool:
        return self.value >= ErrorCode.SPX_WARN_CSXFILE


_DEFAULT_MESSAGES = {
    ErrorCode.SPX_SUCCESS: "success",
    ErrorCode.SPX_FAILURE: "generic failure",
    ErrorCode.SPX_ERR_ARG_INVALID: "invalid argument",
    ErrorCode.SPX_ERR_FILE: "generic file error",
    ErrorCode.SPX_ERR_INPUT_MAT: "invalid input matrix",
    ErrorCode.SPX_ERR_TUNED_MAT: "invalid tuned matrix",
    ErrorCode.SPX_ERR_DIM: "incompatible matrix dimensions",
    ErrorCode.SPX_ERR_VEC_DIM: "incompatible vector dimension",
    ErrorCode.SPX_ERR_ENTRY_NOT_FOUND: "matrix entry not found",
    ErrorCode.SPX_ERR_OUT_OF_BOUNDS: "index out of bounds",
    ErrorCode.SPX_ERR_SYSTEM: "generic system error",
    ErrorCode.SPX_ERR_FILE_OPEN: "failed to open file",
    ErrorCode.SPX_ERR_FILE_READ: "failed to read from file",
    ErrorCode.SPX_ERR_FILE_WRITE: "failed to write to file",
    ErrorCode.SPX_ERR_MEM_ALLOC: "memory allocation failed",
    ErrorCode.SPX_ERR_MEM_FREE: "memory deallocation failed",
    ErrorCode.SPX_WARN_CSXFILE: "invalid CSX file",
    ErrorCode.SPX_WARN_TUNING_OPT: "invalid tuning option",
    ErrorCode.SPX_WARN_ENTRY_NOT_SET: "matrix entry could not be set",
    ErrorCode.SPX_WARN_REORDER: "reordering failed",
}


class SparsexError(Exception):
    """Exception raised for error-level codes."""

    def __init__(self, code: ErrorCode, message: Optional[str] = None,
                 location: Optional[str] = None):
        self.code = ErrorCode(code)
        self.message = message or _DEFAULT_MESSAGES.get(self.code, "unknown error")
        self.location = location
        super().__init__(f"[{self.code.name}] {self.message}"
                         + (f" ({location})" if location else ""))


# Handler signature mirrors spx_errhandler_t: (code, sourcefile, line, function,
# message).  Registered via set_error_handler (ref src/api/error.c:100).
Handler = Callable[[ErrorCode, Optional[str], Optional[int], Optional[str], str], None]


def default_handler(code: ErrorCode, sourcefile: Optional[str], line: Optional[int],
                    function: Optional[str], message: str) -> None:
    loc = ""
    if sourcefile is not None:
        loc = f"{sourcefile}:{line}:{function}: "
    if ErrorCode(code).is_warning:
        log_warning("%s%s", loc, message)
    else:
        log_error("%s%s", loc, message)


_handler: Handler = default_handler


def set_error_handler(handler: Optional[Handler]) -> Handler:
    """Replace the global error handler; returns the previous one.

    Passing ``None`` restores the default handler (parity with
    ``spx_err_set_handler``, ref ``src/api/error.c:100``).
    """
    global _handler
    prev = _handler
    _handler = handler if handler is not None else default_handler
    return prev


def seterror(code: ErrorCode, message: Optional[str] = None, *,
             raise_exc: bool = True) -> None:
    """Report an error through the handler; raise unless ``raise_exc=False``.

    Parity with the SETERROR_0/1 macros (ref ``include/sparsex/error.h:99-110``),
    capturing the caller's location.
    """
    code = ErrorCode(code)
    msg = message or _DEFAULT_MESSAGES.get(code, "unknown error")
    frame = inspect.currentframe()
    caller = frame.f_back if frame else None
    src, line, fn = None, None, None
    if caller is not None:
        src = caller.f_code.co_filename
        line = caller.f_lineno
        fn = caller.f_code.co_name
    _handler(code, src, line, fn, msg)
    if raise_exc and not code.is_warning:
        raise SparsexError(code, msg, f"{src}:{line}" if src else None)


def setwarning(code: ErrorCode, message: Optional[str] = None) -> None:
    """Report a warning through the handler (SETWARNING parity)."""
    seterror(code, message, raise_exc=False)
