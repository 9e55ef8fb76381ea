"""SK of the low service's ``layer`` KernelID in the profile store after
onboarding: the wall time of one routed MoE layer segment, host launch
and synchronisation included, as the scheduler predicts it; beside the
high layers' SG it says whether a layer fits a gap."""


def read(run):
    prof = run.profiles.get("low")
    if prof is None:
        return None
    sk = [v for kid, v in prof.SK.items() if kid.name.endswith("/layer")]
    return 1e3 * sum(sk) / len(sk) if sk else None
