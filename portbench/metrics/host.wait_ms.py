"""host.wait_ms: host ms a update in the program's ``readback.wait`` span
(the host blocked until an event recorded after the step's enqueue has
passed), over the unprofiled window."""

from portbench import program_trace


def read(rec):
    part = program_trace.window(rec)
    return None if part is None else program_trace.span_ms(part,
                                                           "readback.wait")
