"""Error types of the frozen ACE codec."""


class AceFormatError(Exception):
    """Malformed or unsupported ACE table content."""
