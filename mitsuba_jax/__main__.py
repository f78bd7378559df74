from mitsuba_jax.cli import main

raise SystemExit(main())
