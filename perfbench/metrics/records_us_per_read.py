"""records_us_per_read (program span): the program's ``records`` stage
(``_records_fast``: a ``BwaMemAlignment`` a record from the C++ tail's
arrays), per read."""


def read(ctx):
    s = ctx.stage_s.get("records")
    return None if s is None else s * 1e6 / ctx.reads
