"""One driver a mix kind: ``drivers/<kind>.py`` sets a cell up, runs its
window, traces a slice of it and hands its outputs to the comparison."""
