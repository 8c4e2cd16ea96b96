"""Host time blocked on the card per passage over the window: the engine's
``gather.wait`` phase, ``stats()["phases"]["gather.wait"]``. Read in
traced runs only, where the profiler slows the host: biased low."""

from gpubench.readers import us_per_text

UNIT = "us/passage"
SOURCE = "program_span"
MOVES = "passages_per_s"


def read(ctx):
    return us_per_text(ctx, "gather.wait")
