"""graph.launch_ms: host ms a update in the program's ``graph.launch``
span (the replay call of the captured step: ``graph.replay()`` or the
conditional program's launch), over the unprofiled window."""

from portbench import program_trace


def read(rec):
    part = program_trace.window(rec)
    return None if part is None else program_trace.span_ms(part,
                                                           "graph.launch")
