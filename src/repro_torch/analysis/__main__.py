"""``python -m repro_torch.analysis [paths...]`` — the AST lint (PG0xx), or
``python -m repro_torch.analysis plan [--json ...]`` — the plan audit
(PGA1xx). Both exit nonzero on unsuppressed findings."""

import sys


def _main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "plan":
        from .planaudit import main as plan_main

        return plan_main(sys.argv[2:])
    from .lint import main

    return main()


if __name__ == "__main__":
    sys.exit(_main())
