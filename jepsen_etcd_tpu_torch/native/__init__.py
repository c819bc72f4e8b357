"""Native (C++) components: the WGL search driven through ctypes."""

from .oracle import check_entries, get_lib

__all__ = ["check_entries", "get_lib"]
