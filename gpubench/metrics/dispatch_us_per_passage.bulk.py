"""Host time of the engine's dispatch phase per passage over the window:
``stats()['phases']['dispatch']``."""

from gpubench.readers import us_per_text

UNIT = "us/passage"
SOURCE = "program_span"
MOVES = "passages_per_s"


def read(ctx):
    return us_per_text(ctx, "dispatch")
