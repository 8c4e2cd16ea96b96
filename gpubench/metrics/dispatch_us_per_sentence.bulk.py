"""Host time of the engine's dispatch phase (each batch's padding or
packing, staging, replay, queuing the copy) per sentence over the window:
``stats()["phases"]["dispatch"]``. Routing is outside it:
``route_us_per_sentence.bulk``."""

from gpubench.readers import us_per_text

UNIT = "us/sentence"
SOURCE = "program_span"
MOVES = "sentences_per_s"


def read(ctx):
    return us_per_text(ctx, "dispatch")
