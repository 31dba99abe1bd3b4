"""cuda_init_s (s, host clock): the part of ``setup_s`` that makes the
card's context: from the harness's import until a first tensor on the
card has synchronised."""


def read(record):
    return record["setup_phases"].get("cuda")
