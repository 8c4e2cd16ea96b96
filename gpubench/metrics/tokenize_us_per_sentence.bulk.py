"""Host time of the engine's tokenize phase per sentence over the window:
``stats()["phases"]["tokenize"]``."""

from gpubench.readers import us_per_text

UNIT = "us/sentence"
SOURCE = "program_span"
MOVES = "sentences_per_s"


def read(ctx):
    return us_per_text(ctx, "tokenize")
