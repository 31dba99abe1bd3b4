"""import_s (s, host clock): the part of ``setup_s`` from the process's
start until torch and the harness are imported (no module of the port
is imported yet)."""


def read(record):
    return record["setup_phases"].get("import")
