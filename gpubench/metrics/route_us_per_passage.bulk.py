"""Host time of the engine's route phase per passage over the window:
``stats()["phases"]["route"]``."""

from gpubench.readers import us_per_text

UNIT = "us/passage"
SOURCE = "program_span"
MOVES = "passages_per_s"


def read(ctx):
    return us_per_text(ctx, "route")
