"""Window seconds over the verified proofs it completed: every proof that
started in the window is in it, so this is a proof's time taken over all
the work and all the time of the window."""


def read(run):
    if run.noun != "proof" or not run.n_ok:
        return None
    return run.window_s / run.n_ok
