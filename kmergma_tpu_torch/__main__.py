from .utils.cli import main

raise SystemExit(main())
