"""host.readback_ms: host ms a update in the program's ``readback`` span
and in none of its children: the copy to the host, the unpacking, the
counts and the bucket check, without the wait (``readback.wait``) or an
overflow re-run's ``device_step``; over the unprofiled window."""

from portbench import program_trace


def read(rec):
    part = program_trace.window(rec)
    return None if part is None else program_trace.self_ms(part, "readback")
