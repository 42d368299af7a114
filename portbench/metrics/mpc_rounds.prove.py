"""Messages a party sends a proof: each party's `send` calls on its network,
counted at the network object, averaged over the parties."""

NEEDS = ("mpc_sends",)


def read(run):
    tallies = run.counters.sends
    if not tallies:
        return None
    return sum(t["send"] for t in tallies) / len(tallies)
