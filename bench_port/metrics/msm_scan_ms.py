"""Device ms a commit call spends in the program's ``scan`` stage
(``collect_stages``, CUDA events), over the traced window's calls."""


def read(rec):
    ms = rec["stages_ms"].get("scan")
    return ms / rec["commit_calls"] if ms is not None and rec["commit_calls"] else None
