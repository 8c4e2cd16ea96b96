"""Host time blocked on the card per sentence over the window: the
engine's ``gather.wait`` phase (each batch's copy home awaited),
``stats()["phases"]["gather.wait"]``. The host's slack on the card: work
taken off the card shrinks it, work taken off the host grows it.
Read in traced runs only, where the profiler slows the host: biased low."""

from gpubench.readers import us_per_text

UNIT = "us/sentence"
SOURCE = "program_span"
MOVES = "sentences_per_s"


def read(ctx):
    return us_per_text(ctx, "gather.wait")
