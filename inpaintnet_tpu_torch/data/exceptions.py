"""Dataset exceptions (reference DatasetManager/exceptions.py:1-23).

The port's copy of ``inpaintnet_tpu/data/exceptions.py``, numpy only: the two must
give the same bytes.
"""


class TieException(Exception):
    pass


class ParsingException(Exception):
    pass


class LeadsheetParsingException(ParsingException):
    pass
