"""Of the rounds the server's drain loop finished, the share it finished
after the next round had been begun: Δ``rounds_overlapped`` / Δ``rounds``
of ``stats()["serving"]``, over the window before the traced sub-window.
None where the program keeps no such counter or finished no round, and
where the run took no device trace: on the CPU a plan call has done its
work when it returns, so no device work is left for a round to overlap."""


def read(ctx):
    s0, s1 = ctx.serving
    if ctx.trace is None or "rounds" not in s1 or "rounds_overlapped" not in s1:
        return None
    rounds = s1["rounds"] - s0["rounds"]
    return (s1["rounds_overlapped"] - s0["rounds_overlapped"]) / rounds if rounds else None
