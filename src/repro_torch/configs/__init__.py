"""The paper's experiment configurations (a copy of ``repro.configs.dsba_paper``)."""
