"""SOFA (AES69) HRTF and impulse-response files."""

from .reader import SOFAFile, write_sofa

__all__ = ["SOFAFile", "write_sofa"]
