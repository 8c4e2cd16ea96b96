"""Host time of the engine's route phase (the lengths, the packing plan
and the packed-or-bucketed decision, outside dispatch) per sentence over
the window: ``stats()["phases"]["route"]``."""

from gpubench.readers import us_per_text

UNIT = "us/sentence"
SOURCE = "program_span"
MOVES = "sentences_per_s"


def read(ctx):
    return us_per_text(ctx, "route")
